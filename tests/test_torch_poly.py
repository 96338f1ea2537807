"""PyTorch port, polynomial layer: sonic_tpu_torch.poly vs sonic_tpu.poly
and the golden sparse Laurent arithmetic. Exact comparisons, limb for limb.

Known trap: the closed-form division (`_div_linear_jit`) is wrong at z = 0
because inv(0) = 0; there the port is held against the sequential
synthetic division and golden, never against sonic_tpu.
"""
import random

import numpy as np
import pytest
import torch

from sonic_tpu import golden_protocol as gp
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu.poly import laurent as jl
from sonic_tpu.poly import ntt as jntt
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FR
from sonic_tpu_torch.poly import laurent, ntt

torch.set_num_threads(1)


def _terms(rng, lo, hi):
    return {e: rng.randrange(R_MOD) for e in range(lo, hi + 1)}


def _both(terms):
    j = jl.Laurent.from_terms(terms)
    return j, laurent.Laurent(j.offset, torch.from_numpy(np.asarray(j.coeffs).astype(np.int64)))


def assert_same(jax_poly, poly):
    assert jax_poly.offset == poly.offset
    assert np.array_equal(np.asarray(jax_poly.coeffs).astype(np.int64), poly.coeffs.numpy())


@pytest.mark.parametrize(
    "spans",
    [((-5, 7), (-3, 4)), ((-40, 39), (0, 69))],
    ids=["schoolbook", "ntt"],
)
def test_mul_both_branches(spans):
    """13 x 8 pairwise products take the schoolbook branch; 80 x 70 = 5600
    (>= 64 * 64) take the NTT branch."""
    rng = random.Random(21)
    (f, g) = (_terms(rng, *s) for s in spans)
    (jf, tf), (jg, tg) = _both(f), _both(g)
    got = laurent.mul(tf, tg)
    assert_same(jl.mul(jf, jg), got)
    assert got.to_terms() == gp.lp_mul(f, g)


def test_add_sub_scale_evaluate():
    rng = random.Random(22)
    f, g = _terms(rng, -6, 5), _terms(rng, -2, 9)
    (jf, tf), (jg, tg) = _both(f), _both(g)
    assert_same(jl.add(jf, jg), laurent.add(tf, tg))
    assert_same(jl.sub(jf, jg), laurent.sub(tf, tg))
    c = rng.randrange(1, R_MOD)
    assert_same(jl.scale(jf, JFR.from_int(c)), laurent.scale(tf, FR.from_int(c)))
    z = rng.randrange(1, R_MOD)
    want = jl.evaluate(jf, JFR.from_int(z))
    got = laurent.evaluate(tf, FR.from_int(z))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    assert FR.to_int(got) == gp.lp_eval(f, z)


def test_div_by_linear():
    rng = random.Random(23)
    f = _terms(rng, -4, 9)
    jf, tf = _both(f)
    z = rng.randrange(1, R_MOD)
    jfz, jw = jl.div_by_linear(jf, JFR.from_int(z))
    fz, w = laurent.div_by_linear(tf, FR.from_int(z))
    assert np.array_equal(np.asarray(jfz).astype(np.int64), fz.numpy())
    assert_same(jw, w)
    assert w.to_terms() == gp.lp_div_linear(f, z)
    # the sequential oracle agrees with the closed form
    chat = tf.coeffs.clone()
    chat[4] = FR.from_int((f[0] - gp.lp_eval(f, z)) % R_MOD)
    assert torch.equal(laurent._div_linear_seq(chat, FR.from_int(z)), w.coeffs)


def test_div_by_linear_at_zero_uses_the_sequential_oracle():
    rng = random.Random(24)
    f = _terms(rng, 0, 7)
    f[0] = 0  # f(0) = 0, so f / X is exact
    tf = laurent.Laurent.from_terms(f)
    w = laurent._div_linear_seq(tf.coeffs, FR.zeros())
    assert laurent.Laurent(0, w).to_terms() == {e - 1: c for e, c in f.items() if e > 0}


def test_batched_variants():
    rng = random.Random(25)
    M, D, off = 3, 11, -4
    rows = [[rng.randrange(R_MOD) for _ in range(D)] for _ in range(M)]
    zs = [rng.randrange(1, R_MOD) for _ in range(M)]
    jc, jz = JFR.from_int(rows), JFR.from_int(zs)
    tc, tz = FR.from_int(rows), FR.from_int(zs)
    jfz, jw = jl.div_by_linear_batched(off, jc, jz)
    fz, w = laurent.div_by_linear_batched(off, tc, tz)
    assert np.array_equal(np.asarray(jfz).astype(np.int64), fz.numpy())
    assert np.array_equal(np.asarray(jw).astype(np.int64), w.numpy())
    jo, js = jl.add_batched(off, jc, 2, jc[:, :5])
    o, s = laurent.add_batched(off, tc, 2, tc[:, :5])
    assert jo == o and np.array_equal(np.asarray(js).astype(np.int64), s.numpy())
    want = jl.mul_batched(jc, jc)
    assert np.array_equal(np.asarray(want).astype(np.int64), laurent.mul_batched(tc, tc).numpy())


def test_ntt_roundtrip_and_root_of_unity():
    rng = random.Random(26)
    coeffs = [rng.randrange(R_MOD) for _ in range(16)]
    A = FR.from_int(coeffs)
    fwd = ntt.ntt(A)
    assert np.array_equal(np.asarray(jntt.ntt(JFR.from_int(coeffs))).astype(np.int64), fwd.numpy())
    assert FR.to_int(ntt.ntt(fwd, inverse=True)).tolist() == coeffs
    assert ntt.root_of_unity(5) == jntt.root_of_unity(5)
