"""PyTorch port, what BASELINE config 4 at its own size (n = 2^20, q = 64)
needs, at the tests' sizes with the step budget monkeypatched small:

  - MSMs cut along their points (`pippenger._n_slices`): `msm`,
    `msm_batched` (cut along M and N) and `msm_windows` against the JAX
    package's `msm`, golden and the port's uncut calls, in affine form;
  - the four-step product (`poly/ntt.py`, above the step) against the
    radix-2 one and the JAX package's `poly_mul_ntt`, the same Montgomery
    integers;
  - the weight upload (`constraints._weights`) against `FR.from_int`;
  - `breakdown --check` on the CPU with every cut at once (N, the
    helper's instances, the four-step product, the SRS's fixed-base
    chunks): its proof against the golden prover's.
"""
import collections
import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonic_tpu import golden
from sonic_tpu import golden_protocol as jgp
from sonic_tpu import serial as jserial
from sonic_tpu.circuit import random_circuit as jrandom_circuit
from sonic_tpu.curve.group import Affine as JAffine
from sonic_tpu.curve.group import g1 as jg1
from sonic_tpu.fields.limb import FQ as JFQ
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu.msm import pippenger as jpp
from sonic_tpu.poly import ntt as jntt
from sonic_tpu_torch import breakdown, budget, signature
from sonic_tpu_torch.circuit import example_circuit_2, random_circuit
from sonic_tpu_torch.constraints import DeviceCircuit, _weights
from sonic_tpu_torch.curve.group import Affine, g1
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FR
from sonic_tpu_torch.msm import pippenger
from sonic_tpu_torch.poly import ntt

torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np_scalars(rng, shape) -> list:
    """Random Fr integers below the modulus from numpy's generator."""
    raw = rng.integers(0, 1 << 63, size=tuple(shape) + (4,), dtype=np.uint64)
    flat = [sum(int(w) << (64 * i) for i, w in enumerate(r)) % R_MOD for r in raw.reshape(-1, 4)]
    return np.array(flat, dtype=object).reshape(shape).tolist()


def test_n_cut_msm_matches_jax_and_golden(monkeypatch):
    """N = 12 points (one at infinity) at c = 4 (W = 65): with a budget of
    4 N-points' digit slots, one MSM runs in 3 slices of its points and a
    batch of M = 3 in 3 slices of M, each in 3 slices of N; msm,
    msm_batched and msm_windows + combine_windows give golden's sums,
    sonic_tpu's msm and msm_batched, and the port's uncut calls."""
    rng = np.random.default_rng(20)
    N, M, c = 12, 3, 4
    W = 256 // c + 1
    pts = [golden.g1_mul(golden.G1_GEN, k) for k in _np_scalars(rng, (N,))]
    pts[7] = None
    scalars = _np_scalars(rng, (M, N))
    scalars[1][3] = 0
    want = [golden.g1_msm(pts, s) for s in scalars]
    ja = JAffine(JFQ.from_int([p[0] if p else 0 for p in pts]),
                 JFQ.from_int([p[1] if p else 0 for p in pts]),
                 jnp.asarray([p is None for p in pts]))
    js = JFR.from_int(scalars, mont=False)
    jgot = jg1.to_affine(jpp.msm(jg1, ja, js[0], c))
    assert g1.to_host(Affine(to_torch(jgot.x)[None], to_torch(jgot.y)[None],
                             torch.from_numpy(np.array(jgot.inf)).reshape(1))) == want[:1]
    jbatch = jg1.to_affine(jpp.msm_batched(jg1, ja, js, c))
    assert g1.to_host(Affine(to_torch(jbatch.x), to_torch(jbatch.y), torch.from_numpy(np.array(jbatch.inf)))) == want

    points = Affine(to_torch(ja.x), to_torch(ja.y), torch.from_numpy(np.array(ja.inf)))
    sc = to_torch(js)
    uncut = [g1.to_host(g1.to_affine(pippenger.msm(points, sc[0], c).map(lambda a: a[None])))[0],
             g1.to_host(g1.to_affine(pippenger.msm_batched(points, sc, c)))]
    assert uncut == [want[0], want]
    monkeypatch.setattr(budget, "STEP_BYTES", 4 * W * budget.SLOT_BYTES)
    assert pippenger._n_slices(N, W) == [(0, 4), (4, 8), (8, 12)]
    assert pippenger._n_slices(10, W) == [(0, 3), (3, 6), (6, 10)]
    assert pippenger._n_slices(4, W) == [(0, 4)]
    assert pippenger._m_slices(M, N, W) == [(0, 1), (1, 2), (2, 3)]
    before = collections.Counter(pippenger.n_slicings), collections.Counter(pippenger.slicings)
    calls: list = []
    real = pippenger.bucket_sums
    monkeypatch.setattr(pippenger, "bucket_sums", lambda p, plan: calls.append(plan.npoints) or real(p, plan))
    got = g1.to_host(g1.to_affine(pippenger.msm(points, sc[0], c).map(lambda a: a[None])))
    assert got == want[:1] and calls == [4, 4, 4]
    assert pippenger.n_slicings - before[0] == {(1, N, 3): 1}
    got = g1.to_host(g1.to_affine(pippenger.msm_batched(points, sc, c)))
    assert got == want and len(calls) == 3 + 9
    totals = pippenger.msm_windows(points, sc, c)
    assert g1.to_host(g1.to_affine(pippenger.combine_windows([totals])[0])) == want
    assert pippenger.n_slicings - before[0] == {(1, N, 3): 1, (M, N, 3): 2}
    assert pippenger.slicings - before[1] == {(M, N, 3): 2}


@pytest.mark.parametrize("shape", [(), (3,)], ids=["one", "batched"])
def test_four_step_product_matches_radix2_and_jax(monkeypatch, shape):
    """A product of 100 x 90 coefficients (a transform of 256 = 16 x 16)
    with the step at 40 coefficients' COEFF_BYTES: the four-step split in
    batches of one column and of one row, the same Montgomery integers as
    the radix-2 product and sonic_tpu's poly_mul_ntt (per instance with
    trailing instances)."""
    rng = np.random.default_rng(21)
    a_int = _np_scalars(rng, (100,) + shape)
    b_int = _np_scalars(rng, (90,) + shape)
    a, b = FR.from_int(a_int), FR.from_int(b_int)
    radix2 = ntt.poly_mul_ntt(a, b)
    monkeypatch.setattr(budget, "STEP_BYTES", 40 * budget.COEFF_BYTES)
    calls: list = []
    real = ntt._four_step
    monkeypatch.setattr(ntt, "_four_step", lambda x, inverse=False: calls.append(inverse) or real(x, inverse))
    got = ntt.poly_mul_ntt(a, b)
    assert calls == [False, False, True]
    assert torch.equal(got, radix2)
    cols = [(a_int, b_int)] if not shape else [
        ([r[i] for r in a_int], [r[i] for r in b_int]) for i in range(shape[0])]
    for i, (ai, bi) in enumerate(cols):
        want = np.asarray(jntt.poly_mul_ntt(JFR.from_int(ai), JFR.from_int(bi))).astype(np.int64)
        assert np.array_equal(want, (got if not shape else got[:, i]).numpy())


def test_weight_upload_matches_from_int():
    """Weights of a random circuit (0/1 rows), of example 2 (-1 mod r, past
    int64) and rows with a negative or 2^63 - 1: the same limbs as
    FR.from_int."""
    circuit, _ = random_circuit(random.Random(22), n=16, q=5)
    ex2, _ = example_circuit_2(x=1, z=2)
    for rows in (circuit.weights.wL, circuit.weights.wO, ex2.weights.wO,
                 [[0, 3, (1 << 63) - 1], [7, 1, 0]], [[1, -2, 3]], [[5, R_MOD + 1]]):
        assert torch.equal(_weights(rows, "cpu"), FR.from_int([list(r) for r in rows]))
    dc = DeviceCircuit.from_host(circuit, device="cpu")
    assert torch.equal(dc.wR, FR.from_int([list(r) for r in circuit.weights.wR]))


def test_breakdown_check_with_every_cut_matches_golden(monkeypatch, capsys):
    """`breakdown --check` at n = 8, q = 2 on the CPU under a step budget
    that cuts every MSM over 24 or more points along N (r', t, the
    helper's), runs the helper one instance a slice, takes the four-step
    product for t (the NTT branch forced from 512 pairwise products) and
    builds the SRS in fixed-base chunks of 40 rows: verify True and False
    once tampered, pr_r and pr_t
    equal to native host MSMs, the SRS rows at every chunk boundary equal
    to golden, and its proof's sha256 equal to the golden prover's on the
    same circuit, trapdoor and randomness."""
    n, q, seed = 8, 2, 20
    rng = random.Random(seed)
    circuit, assignment = jrandom_circuit(rng, n=n, q=q)
    x, alpha = rng.randrange(2, jgp.P), rng.randrange(2, jgp.P)
    rnd = jgp.Randomness.generate(rng, m=q)
    proof, _ = jgp.prove(jgp.SRS.new(7 * n + 20, x=x, alpha=alpha), assignment, circuit, rnd)
    want = hashlib.sha256(jserial.proof_to_bytes(proof)).hexdigest()

    monkeypatch.setenv("SONIC_TPU_NTT_THRESHOLD", "512")
    monkeypatch.setattr(budget, "STEP_BYTES", 24 * 65 * budget.SLOT_BYTES - 1)
    monkeypatch.setattr(budget, "INSTANCE_BYTES", budget.STEP_BYTES // (3 * n + 1))
    monkeypatch.setattr(budget, "BASE_ROW_BYTES", {"G1": budget.STEP_BYTES // 40, "G2": budget.STEP_BYTES // 40})
    n_before = collections.Counter(pippenger.n_slicings)
    h_before = collections.Counter(signature.slicings)
    calls: list = []
    real = ntt._four_step
    monkeypatch.setattr(ntt, "_four_step", lambda x_, inverse=False: calls.append(inverse) or real(x_, inverse))
    assert breakdown.main(["--device", "cpu", "--gates", str(n), "--q", str(q), "--seed", str(seed),
                           "--reps", "0", "--check"]) == 0
    out = capsys.readouterr().out
    assert f"check: 2 proves, one proof, sha256 {want}" in out
    assert "check: passed" in out and "slice(s) of N" in out
    assert signature.slicings - h_before == {(q, n, q): 2}
    assert all(k > 1 for _, _, k in (pippenger.n_slicings - n_before))
    assert calls.count(True) == 3  # t's product in both proves and in --check's pr_t
