"""PyTorch port, Fq2 and G2: sonic_tpu_torch.fields.ext, curve.group.g2 and
msm.fixed_base vs sonic_tpu.fields.ext, curve.group.g2, msm.fixed_base and
the golden host law.

Fq2 values are compared limb for limb. G2 points are compared in affine
form, and the complete addition's projective output limb for limb too (it
is computed step for step as in the reference). A count of limb.mul calls
shows that each Fq2 product group reaches kernel 1 in one launch: a G2
group op makes as many as its G1 twin. All comparisons are exact.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonic_tpu import golden as jgolden
from sonic_tpu.curve.group import Affine as JAffine
from sonic_tpu.curve.group import g1 as jg1
from sonic_tpu.curve.group import g2 as jg2
from sonic_tpu.fields import ext as jext
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu.msm.fixed_base import fixed_base_mul as jax_fixed_base_mul
from sonic_tpu_torch import golden
from sonic_tpu_torch.curve.group import Affine, g1, g2
from sonic_tpu_torch.fields import ext, limb
from sonic_tpu_torch.fields.constants import Q_MOD, R_MOD
from sonic_tpu_torch.fields.limb import FQ, FR
from sonic_tpu_torch.msm.fixed_base import fixed_base_mul

torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def assert_same(jax_array, tensor):
    assert tensor.dtype == torch.int64
    assert np.array_equal(np.asarray(jax_array).astype(np.int64), tensor.numpy())


def _fq2_batch(seed, n):
    """n canonical Fq2 limb vectors from numpy, then 0, 1 and u."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(n, 2, FQ.nlimbs), dtype=np.int64)
    a[..., -1] = rng.integers(0, FQ.mod_limbs[-1], size=(n, 2))
    special = ext.from_int([(0, 0), (1, 0), (0, 1)]).numpy()
    return np.concatenate([a, special]).astype(np.uint32)


def test_fq2_ops_match_jax():
    a_np, b_np = _fq2_batch(11, 13), _fq2_batch(12, 13)[::-1].copy()
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    a, b = to_torch(a_np), to_torch(b_np)
    assert_same(jext.add(ja, jb), ext.add(a, b))
    assert_same(jext.sub(ja, jb), ext.sub(a, b))
    assert_same(jext.neg(ja), ext.neg(a))
    assert_same(jext.mul(ja, jb), ext.mul(a, b))
    assert_same(jext.mul(ja, jb[3]), ext.mul(a, b[3]))  # a broadcast operand
    assert_same(jext.sqr(ja), ext.sqr(a))
    assert_same(jext.mul_small(ja, 12), ext.mul_small(a, 12))
    assert_same(jext.mul_b3(ja), ext.mul_b3(a))
    assert_same(jext.inv(ja), ext.inv(a))  # the 0 row stays 0
    assert_same(jext.batch_inv(ja), ext.batch_inv(a))
    for jm, m in zip(jext.mul_many([(ja, jb), (jb, jb)]), ext.mul_many([(a, b), (b, b)])):
        assert_same(jm, m)
    assert np.array_equal(np.asarray(jext.is_zero(ja)), ext.is_zero(a).numpy())
    assert ext.to_int(ext.from_int((5, 7))) == (5, 7)
    # u * u = -1
    u = ext.from_int((0, 1))
    assert ext.to_int(ext.mul(u, u)) == (Q_MOD - 1, 0)


def _count_muls(monkeypatch):
    calls = []
    real = limb.mul

    def counting(a, b, spec):
        calls.append(spec.name)
        return real(a, b, spec)

    monkeypatch.setattr(limb, "mul", counting)
    return calls


def test_group_ops_make_as_many_kernel_launches_in_g2_as_in_g1(monkeypatch):
    """double / add / add_mixed: two stacked mul_many calls each, so two
    limb.mul calls (two kernel-1 launches on the card) in either group."""
    counts = {}
    for grp in (g1, g2):
        gen = grp.generator()
        P = grp.double(grp.from_affine(gen))
        calls = _count_muls(monkeypatch)
        grp.double(P)
        n_double = len(calls)
        grp.add(P, P)
        n_add = len(calls) - n_double
        grp.add_mixed(P, gen)
        counts[grp.name] = (n_double, n_add, len(calls) - n_double - n_add)
        monkeypatch.undo()
    assert counts["G1"] == counts["G2"] == (2, 2, 2)
    calls = _count_muls(monkeypatch)
    ext.mul_many([(ext.ones(), ext.ones())] * 5)
    assert len(calls) == 1


def _g2_points(rng, n, inf_at=()):
    pts = [golden.g2_mul(golden.G2_GEN, rng.randrange(1, R_MOD)) for _ in range(n)]
    for i in inf_at:
        pts[i] = None
    return pts


def _jax_g2_affine(pts) -> JAffine:
    x = [p[0] if p else (0, 0) for p in pts]
    y = [p[1] if p else (0, 0) for p in pts]
    return JAffine(
        jext.make(jext.FQ.from_int([c[0] for c in x]), jext.FQ.from_int([c[1] for c in x])),
        jext.make(jext.FQ.from_int([c[0] for c in y]), jext.FQ.from_int([c[1] for c in y])),
        jnp.asarray([p is None for p in pts]),
    )


def _jax_g2_host(aff: JAffine) -> list:
    x0, x1 = jext.to_int(np.asarray(aff.x))
    y0, y1 = jext.to_int(np.asarray(aff.y))
    return [
        None if f else ((int(a), int(b)), (int(c), int(d)))
        for a, b, c, d, f in zip(x0, x1, y0, y1, np.asarray(aff.inf).tolist())
    ]


def test_g2_ops_match_jax():
    """add / add_mixed / double / neg / to_affine vs sonic_tpu's g2, with
    infinity and P + P among the inputs."""
    rng = random.Random(21)
    pts = _g2_points(rng, 8, inf_at=(0,))
    qts = _g2_points(rng, 8, inf_at=(5,))
    qts[3] = pts[3]
    ja, jb = _jax_g2_affine(pts), _jax_g2_affine(qts)
    ta = g2.from_host(pts)
    tb = g2.from_host(qts)
    for j, t in ((ja, ta), (jb, tb)):
        assert_same(j.x, t.x)
        assert_same(j.y, t.y)
    jP, jQ = jg2.from_affine(ja), jg2.from_affine(jb)
    P, Q = g2.from_affine(ta), g2.from_affine(tb)
    want_add = [jgolden.g2_add(p, q) for p, q in zip(pts, qts)]
    for jax_pt, port_pt, want in [
        (jP, P, pts),
        (jg2.add(jP, jQ), g2.add(P, Q), want_add),
        (jg2.add_mixed(jP, jb), g2.add_mixed(P, tb), want_add),
        (jg2.double(jP), g2.double(P), [jgolden.g2_add(p, p) for p in pts]),
        (jg2.neg(jP), g2.neg(P), [jgolden.g2_neg(p) for p in pts]),
    ]:
        got = g2.to_affine(port_pt)
        jgot = jg2.to_affine(jax_pt)
        assert_same(jgot.x, got.x)
        assert_same(jgot.y, got.y)
        assert g2.to_host(got) == _jax_g2_host(jgot) == want
    for a, b in zip(jg2.add(jP, jQ), g2.add(P, Q)):
        assert_same(a, b)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_fixed_base_mul_matches_jax(name):
    """Scalars 0, 1, r-1, scalars with zero 8-bit digits, and random ones."""
    grp, jgrp = (g1, jg1) if name == "G1" else (g2, jg2)
    host_mul = jgolden.g1_mul if name == "G1" else jgolden.g2_mul
    gen = jgolden.G1_GEN if name == "G1" else jgolden.G2_GEN
    rng = np.random.default_rng(31)
    ks = [0, 1, R_MOD - 1, 1 << 200, 0x0100_0000_0001, 255 << 128]
    ks += [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(4)]
    js = JFR.from_int(ks, mont=False)
    got = grp.to_affine(fixed_base_mul(grp, to_torch(js)))
    want = jgrp.to_affine(jax_fixed_base_mul(jgrp, js))
    assert_same(want.x, got.x)
    assert_same(want.y, got.y)
    assert np.array_equal(np.asarray(want.inf), got.inf.numpy())
    assert grp.to_host(got) == [host_mul(gen, k) for k in ks]
    assert FR.to_int(to_torch(js), mont=False).tolist() == ks
