"""PyTorch port on an NVIDIA card: each CUDA kernel against its plain
version on the same CUDA tensors, and the pinned example2 proof on the card.

Every test here needs a CUDA device; it skips elsewhere. This file imports
neither jax nor sonic_tpu, and the card's machine has no jax, so run it
there without the repository's conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

All comparisons are exact (every value is an integer).
"""
import json
import os
import random

import pytest
import torch

from sonic_tpu_torch import golden, protocol, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import example_circuit_2
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.curve.group import Affine
from sonic_tpu_torch.fields import limb, mont_mul
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FQ, FR
from sonic_tpu_torch.msm import bucket_acc
from sonic_tpu_torch.srs import SRS

pytestmark = pytest.mark.cuda

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "pinned_v1.json")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _elems(rng, mod, n):
    return [rng.randrange(mod) for _ in range(n - 3)] + [0, 1, mod - 1]


@pytest.mark.parametrize("spec", [FR, FQ], ids=["Fr", "Fq"])
def test_mont_mul_kernel_equals_plain(dev, spec):
    """4099 products (a ragged last block) with 0, 1 and N-1, plus a
    broadcast constant operand (from_mont's raw 1, read with stride 0)."""
    rng = random.Random(31)
    a = spec.from_int(_elems(rng, spec.modulus, 4099), device=dev)
    b = spec.from_int(_elems(rng, spec.modulus, 4099)[::-1], device=dev)
    before = mont_mul.launches
    got = mont_mul.mont_mul(a, b, spec)
    assert mont_mul.launches == before + 1
    assert torch.equal(got, mont_mul.mont_mul_plain(a, b, spec))
    assert torch.equal(got.cpu(), mont_mul.mont_mul_plain(a.cpu(), b.cpu(), spec))
    std = limb.from_mont(a, spec)
    assert torch.equal(std, mont_mul.mont_mul_plain(a, spec.raw_one(dev), spec))
    assert spec.to_int(std, mont=False).tolist() == spec.to_int(a).tolist()


def test_mont_mul_rejects_what_the_kernel_does_not_take(dev):
    a = FR.from_int([3, 4], device=dev)
    with pytest.raises(TypeError):
        mont_mul.mont_mul(a.to(torch.int32), a, FR)
    with pytest.raises(ValueError):
        mont_mul.mont_mul(a, FQ.from_int([3, 4], device=dev), FR)
    with pytest.raises(ValueError):
        mont_mul.mont_mul(a, a.cpu(), FR)


def _points(rng, n, dev):
    pts = [golden.g1_mul(golden.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(n)]
    pts[1] = pts[n - 2] = None
    return Affine(
        FQ.from_int([p[0] if p else 0 for p in pts], device=dev),
        FQ.from_int([p[1] if p else 0 for p in pts], device=dev),
        torch.tensor([p is None for p in pts], device=dev),
    )


@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batched"])
def test_bucket_acc_kernel_equals_plain(dev, batch):
    """K=8 lanes of T=5 points, W=3 windows, c=4 (9 buckets), infinities
    and digits of both signs: the whole bucket grid, bit for bit."""
    K, T, W, nb = 8, 5, 3, 9
    flat = _points(random.Random(32), K * T, dev)
    pts = Affine(flat.x.reshape(K, T, -1), flat.y.reshape(K, T, -1), flat.inf.reshape(K, T))
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    shape = (K, T, W) if batch is None else (batch, K, T, W)
    digits = torch.randint(-(nb - 1), nb, shape, generator=gen, device=dev)
    before = bucket_acc.launches
    got = bucket_acc.accumulate(pts, digits, nb)
    assert bucket_acc.launches == before + 1
    want = bucket_acc.accumulate_plain(pts, digits, nb)
    assert got.x.shape == shape[:-3] + (K, W, nb, FQ.nlimbs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pinned_example2_proof_on_the_card(dev):
    with open(VEC_PATH) as f:
        vec = json.load(f)["example2"]
    r = vec["rnd"]
    rnd = gp.Randomness(cns=r["cns"], y=r["y"], z=r["z"], ys=r["ys"], zs=r["zs"], u=r["u"], v=r["v"])
    circuit, assignment = example_circuit_2(x=1, z=2)
    srs = SRS.from_host(gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"]), device=dev)
    dc = DeviceCircuit.from_host(circuit, device=dev)
    da = DeviceAssignment.from_host(assignment, device=dev)
    mont_mul.launches = bucket_acc.launches = 0
    proof, oracle = protocol.prove(srs, da, dc, rnd)
    assert mont_mul.launches > 0 and bucket_acc.launches > 0
    assert serial.proof_to_bytes(proof).hex() == vec["proof_hex"]
    assert protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
