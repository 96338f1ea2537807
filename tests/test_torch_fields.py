"""PyTorch port, field layer: sonic_tpu_torch.fields vs sonic_tpu.fields.

The same seeded inputs go through the JAX function and its port; outputs
are compared as integers, limb for limb (exact: no tolerance). Where the
JAX side reaches its Pallas kernel, it runs in interpret mode, as in
tests/test_fields.py. The CUDA kernel itself runs only on a card
(chip_smoke.py); here the wrappers take their plain versions because the
tensors lie on the CPU.
"""
import random

import numpy as np
import pytest
import torch

from sonic_tpu.fields import limb as jlimb
from sonic_tpu.fields.pallas_mul import mont_mul as jax_mont_mul
from sonic_tpu_torch.fields import limb, mont_mul
from sonic_tpu_torch.fields.constants import Q_MOD, R_MOD

torch.set_num_threads(1)

SPECS = [(jlimb.FR, limb.FR, R_MOD), (jlimb.FQ, limb.FQ, Q_MOD)]
IDS = ["Fr", "Fq"]


def to_torch(jax_array) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax_array).astype(np.int64))


def assert_same(jax_array, tensor):
    """Limb tensors: int64, value for value; flags: the same booleans."""
    want = np.asarray(jax_array)
    if want.dtype == bool:
        assert tensor.dtype == torch.bool and np.array_equal(want, tensor.numpy())
        return
    assert tensor.dtype == torch.int64
    assert np.array_equal(want.astype(np.int64), tensor.numpy())


def _elems(rng, mod, n):
    return [rng.randrange(mod) for _ in range(n - 3)] + [0, 1, mod - 1]


@pytest.mark.parametrize("jspec,tspec,mod", SPECS, ids=IDS)
def test_mont_mul_plain_matches_jax(jspec, tspec, mod):
    """mont_mul_plain == limb._mul_lm == the Pallas kernel (interpret mode)
    at n=700 (more than one 512-wide panel), with 0, 1 and N-1."""
    rng = random.Random(11)
    n = 700
    a = _elems(rng, mod, n)
    b = _elems(rng, mod, n)[::-1]
    A, B = jspec.from_int(a), jspec.from_int(b)
    want = jlimb._from_lm(jlimb._mul_lm(jlimb._to_lm(A), jlimb._to_lm(B), jspec))
    got = mont_mul.mont_mul_plain(to_torch(A), to_torch(B), tspec)
    assert_same(want, got)
    assert_same(jax_mont_mul(A, B, jspec, interpret=True), got)
    # the public entry takes the plain version for CPU tensors
    assert torch.equal(limb.mul(to_torch(A), to_torch(B), tspec), got)
    assert mont_mul.launches == 0


@pytest.mark.parametrize("jspec,tspec,mod", SPECS, ids=IDS)
def test_field_ops_match_jax(jspec, tspec, mod):
    rng = random.Random(12)
    a = _elems(rng, mod, 16)
    b = _elems(rng, mod, 16)[::-1]
    A, B = jspec.from_int(a), jspec.from_int(b)
    tA, tB = to_torch(A), to_torch(B)
    assert_same(A, tspec.from_int(a))
    assert tspec.to_int(tA).tolist() == a
    assert_same(jlimb.add(A, B, jspec), limb.add(tA, tB, tspec))
    assert_same(jlimb.sub(A, B, jspec), limb.sub(tA, tB, tspec))
    assert_same(jlimb.neg(A, jspec), limb.neg(tA, tspec))
    assert_same(jlimb.mul_small(A, 12, jspec), limb.mul_small(tA, 12, tspec))
    assert_same(jlimb.inv(A, jspec), limb.inv(tA, tspec))
    assert_same(jlimb.batch_inv(A, jspec), limb.batch_inv(tA, tspec))
    assert_same(jlimb.to_mont(A, jspec), limb.to_mont(tA, tspec))
    assert_same(jlimb.from_mont(A, jspec), limb.from_mont(tA, tspec))
    assert_same(jlimb.powers(A[3], jspec, 37), limb.powers(tA[3], tspec, 37))
    assert_same(jlimb.pow_int(A[4], jspec, -5), limb.pow_int(tA[4], tspec, -5))
    assert_same(jlimb.sum_mod(A, jspec), limb.sum_mod(tA, tspec))
    assert_same(jlimb.is_zero(A), limb.is_zero(tA))
    assert_same(jlimb.eq(A, B), limb.eq(tA, tB))


@pytest.mark.parametrize("jspec,tspec,mod", SPECS, ids=IDS)
def test_carries_at_the_edges(jspec, tspec, mod):
    """Operands that make every limb carry or borrow: N-1 + N-1, 0 - 1,
    (N-1)^2, and all-0xffff limb runs, against Python ints."""
    vals = [0, 1, 2, mod - 1, mod - 2, (1 << 16) - 1, (1 << 200) - 1, mod >> 1]
    A = tspec.from_int(vals)
    B = tspec.from_int(vals[::-1])
    raw = tspec.from_int(vals, mont=False)
    assert tspec.to_int(limb.add(A, B, tspec)).tolist() == [
        (x + y) % mod for x, y in zip(vals, vals[::-1])
    ]
    assert tspec.to_int(limb.sub(A, B, tspec)).tolist() == [
        (x - y) % mod for x, y in zip(vals, vals[::-1])
    ]
    assert tspec.to_int(limb.mul(A, A, tspec)).tolist() == [x * x % mod for x in vals]
    assert tspec.to_int(limb.from_mont(limb.to_mont(raw, tspec), tspec), mont=False).tolist() == vals
