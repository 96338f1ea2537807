"""PyTorch port, curve and MSM layers: sonic_tpu_torch.curve / .msm vs
sonic_tpu.curve / .msm and the golden host MSM.

Points are compared in affine form (projective coordinates depend on the
order of additions), except the bucket grid: accumulate_plain walks each
lane in the reference scatter scan's order, so its grid is compared
coordinate for coordinate. All comparisons are exact.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonic_tpu import golden
from sonic_tpu.curve.group import Affine as JAffine
from sonic_tpu.curve.group import g1 as jg1
from sonic_tpu.fields.limb import FQ as JFQ
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu.msm import pippenger as jpp
from sonic_tpu.msm.pallas_acc import accumulate_batched_pallas, accumulate_pallas
from sonic_tpu_torch.curve.group import Affine, Jacobian, g1
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FQ
from sonic_tpu_torch.msm import bucket_acc, pippenger

torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _host_points(rng, n, inf_at=()):
    pts = [golden.g1_mul(golden.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(n)]
    for i in inf_at:
        pts[i] = None
    return pts


def _jax_affine(points) -> JAffine:
    return JAffine(
        JFQ.from_int([p[0] if p else 0 for p in points]),
        JFQ.from_int([p[1] if p else 0 for p in points]),
        jnp.asarray([p is None for p in points]),
    )


def _port_affine(a: JAffine) -> Affine:
    return Affine(to_torch(a.x), to_torch(a.y), torch.from_numpy(np.array(a.inf)))


def _host(aff: Affine) -> list:
    xs = np.atleast_1d(FQ.to_int(aff.x.reshape(-1, FQ.nlimbs)))
    ys = np.atleast_1d(FQ.to_int(aff.y.reshape(-1, FQ.nlimbs)))
    infs = aff.inf.reshape(-1).tolist()
    return [None if f else (int(x), int(y)) for x, y, f in zip(xs, ys, infs)]


def _jax_host(aff: JAffine) -> list:
    xs = np.atleast_1d(JFQ.to_int(np.asarray(aff.x).reshape(-1, 24)))
    ys = np.atleast_1d(JFQ.to_int(np.asarray(aff.y).reshape(-1, 24)))
    infs = np.asarray(aff.inf).reshape(-1).tolist()
    return [None if f else (int(x), int(y)) for x, y, f in zip(xs, ys, infs)]


def _assert_grid(jax_grid, grid: Jacobian):
    for a, b in zip(jax_grid, grid):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


def test_accumulate_plain_matches_jax_scan_and_pallas():
    """The shapes of tests/test_pallas_acc.py: 128 lanes, 2 steps, 3
    windows, c=4 (9 buckets), two infinities, digits of both signs."""
    rng = np.random.default_rng(3)
    K, T, W, nb = 128, 2, 3, 9
    pts = _host_points(random.Random(3), K * T, inf_at=(5, 200))
    ja = _jax_affine(pts)
    jp = JAffine(ja.x.reshape(K, T, -1), ja.y.reshape(K, T, -1), ja.inf.reshape(K, T))
    digits = rng.integers(-8, 9, size=(K, T, W), dtype=np.int64)
    jd = jnp.asarray(digits, jnp.int32)
    got = bucket_acc.accumulate(_port_affine(jp), torch.from_numpy(digits), nb)
    _assert_grid(jpp._accumulate_buckets_scatter(jg1, jp, jd, nb, True), got)
    _assert_grid(accumulate_pallas(jp, jd, nb, interpret=True, wb=1, tb=2), got)
    assert bucket_acc.launches == 0


def test_accumulate_rejects_digits_outside_the_buckets():
    K, T, W, nb = 2, 1, 1, 9
    pts = _port_affine(_jax_affine(_host_points(random.Random(9), K * T)))
    pts = Affine(pts.x.reshape(K, T, -1), pts.y.reshape(K, T, -1), pts.inf.reshape(K, T))
    for bad in (9, -9):
        with pytest.raises(ValueError):
            bucket_acc.accumulate(pts, torch.full((K, T, W), bad), nb)


def test_accumulate_plain_batched_matches_jax():
    """M digit sets over one shared point table (the hsc helper's form) vs
    the batched Pallas kernel in interpret mode and the vmapped scan."""
    rng = np.random.default_rng(4)
    M, K, T, W, nb = 32, 4, 2, 2, 9
    pts = _host_points(random.Random(4), K * T, inf_at=(1,))
    ja = _jax_affine(pts)
    jp = JAffine(ja.x.reshape(K, T, -1), ja.y.reshape(K, T, -1), ja.inf.reshape(K, T))
    digits = rng.integers(-8, 9, size=(M, K, T, W), dtype=np.int64)
    jd = jnp.asarray(digits, jnp.int32)
    got = bucket_acc.accumulate_plain(_port_affine(jp), torch.from_numpy(digits), nb)
    _assert_grid(accumulate_batched_pallas(jp, jd, nb, interpret=True, wb=1, tb=2), got)
    ref = jax.vmap(lambda d: jpp._accumulate_buckets_scatter(jg1, jp, d, nb, True))(jd)
    _assert_grid(ref, got)


def test_signed_digits_match_jax():
    rng = random.Random(5)
    scalars = [rng.randrange(R_MOD) for _ in range(20)] + [0, 1, R_MOD - 1]
    js = JFR.from_int(scalars, mont=False)
    for c in (4, 6, 8):
        want = jpp._signed_digits(js, c)
        got = pippenger._signed_digits(to_torch(js), c)
        assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


def test_msm_matches_jax_and_golden():
    """msm with infinity points and zero/one scalars, at the lane count and
    window size of tests/test_msm.py and at the port's own choice."""
    rng = random.Random(6)
    n = 13
    pts = _host_points(rng, n, inf_at=(3,))
    scalars = [rng.randrange(R_MOD) for _ in range(n - 2)] + [0, 1]
    ja = _jax_affine(pts)
    js = JFR.from_int(scalars, mont=False)
    want = golden.g1_msm(pts, scalars)
    assert _jax_host(jg1.to_affine(jpp.msm_g1(ja, js, 4, 4)))[0] == want
    for c, lanes in ((4, 4), (None, None), (5, 3)):
        got = g1.to_affine(pippenger.msm(_port_affine(ja), to_torch(js), c, lanes))
        assert _host(got) == [want]


def test_msm_batched_matches_jax_and_golden():
    rng = random.Random(7)
    n, M = 9, 3
    pts = _host_points(rng, n, inf_at=(2,))
    scalars = [[rng.randrange(R_MOD) for _ in range(n)] for _ in range(M)]
    scalars[1][4] = 0
    ja = _jax_affine(pts)
    js = JFR.from_int(scalars, mont=False)
    want = [golden.g1_msm(pts, s) for s in scalars]
    assert _jax_host(jg1.to_affine(jpp.msm_batched(jg1, ja, js, 4, 4))) == want
    got = g1.to_affine(pippenger.msm_batched(_port_affine(ja), to_torch(js)))
    assert _host(got) == want
    # MSMs finished together by one combine_windows, across window sizes
    parts = [
        pippenger.msm_windows(_port_affine(ja), to_torch(js[0])),
        pippenger.msm_windows(_port_affine(ja), to_torch(js)),
        pippenger.msm_windows(_port_affine(ja), to_torch(js), c=5),
    ]
    single, batch, batch5 = pippenger.combine_windows(parts)
    assert single.x.shape == (FQ.nlimbs,) and batch.x.shape == (M, FQ.nlimbs)
    assert _host(g1.to_affine(single)) == want[:1]
    assert _host(g1.to_affine(batch)) == want
    assert _host(g1.to_affine(batch5)) == want


def test_group_ops_match_jax():
    """add / add_mixed / double / neg / scalar_mul / to_affine vs
    sonic_tpu's g1, with infinity and P + P among the inputs."""
    rng = random.Random(8)
    pts = _host_points(rng, 8, inf_at=(0,))
    qts = _host_points(rng, 8, inf_at=(5,))
    qts[3] = pts[3]  # doubling through the addition law
    ja, jb = _jax_affine(pts), _jax_affine(qts)
    jP, jQ = jg1.from_affine(ja), jg1.from_affine(jb)
    ta, tb = _port_affine(ja), _port_affine(jb)
    P, Q = g1.from_affine(ta), g1.from_affine(tb)
    for jax_pt, port_pt in [
        (jP, P),
        (jg1.add(jP, jQ), g1.add(P, Q)),
        (jg1.add_mixed(jP, jb), g1.add_mixed(P, tb)),
        (jg1.double(jP), g1.double(P)),
        (jg1.neg(jP), g1.neg(P)),
    ]:
        assert _host(g1.to_affine(port_pt)) == _jax_host(jg1.to_affine(jax_pt))
    # the complete formulas are computed step for step as in the
    # reference, so even the projective coordinates agree
    for a, b in zip(jg1.add(jP, jQ), g1.add(P, Q)):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())
    ks = [rng.randrange(R_MOD) for _ in range(8)]
    jk = JFR.from_int(ks, mont=False)
    want = [None if p is None else golden.g1_mul(p, k) for p, k in zip(pts, ks)]
    assert _jax_host(jg1.to_affine(jg1.scalar_mul(jP, jk))) == want
    assert _host(g1.to_affine(g1.scalar_mul(P, to_torch(jk)))) == want
    assert _host(ta) == pts
