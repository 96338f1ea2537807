"""PyTorch port, memory budgets and the names that came with them.

The batched MSM cuts its M axis, `constraints._weighted` its q axis and
`laurent.div_by_linear_batched` its instances into slices, each within
`budget.STEP_BYTES`. At the tests' sizes the budget cuts nothing, so each
test here sets it small (monkeypatch) and holds the cut results against
the JAX package, the golden prover and the port's uncut calls. Also here:
`msm_g2` / the `group` argument against golden G2 multiples,
`laurent.zero` / `neg` and `FieldSpec.from_int` against the JAX package.
All comparisons are exact; MSM results are compared in affine form (cut
plans add in another order, so projective coordinates may differ).
"""
import collections
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonic_tpu import constraints as jcons
from sonic_tpu import golden
from sonic_tpu import golden_protocol as jgp
from sonic_tpu import native as jnative
from sonic_tpu import serial as jserial
from sonic_tpu.curve.group import Affine as JAffine
from sonic_tpu.curve.group import g1 as jg1
from sonic_tpu.fields.limb import FQ as JFQ
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu.msm import pippenger as jpp
from sonic_tpu.poly import laurent as jlaurent
from sonic_tpu_torch import breakdown, budget, constraints, protocol, serial, signature
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import random_circuit
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.curve.group import Affine, g1, g2
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FQ, FR
from sonic_tpu_torch.msm import pippenger
from sonic_tpu_torch.poly import laurent
from sonic_tpu_torch.srs import SRS

torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def test_sliced_msm_batched_matches_jax_and_golden(monkeypatch):
    """M = 5 MSMs over N = 8 points at c = 4 (W = 65 signed windows) with a
    budget of 2 N W digit slots: slices of 2, 2 and 1 MSMs, a plan and a
    bucket-sums call each, then ONE bucket weighted sum and ONE window
    combine."""
    rng = random.Random(11)
    N, M, c = 8, 5, 4
    pts = [golden.g1_mul(golden.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(N)]
    pts[5] = None
    scalars = [[rng.randrange(R_MOD) for _ in range(N)] for _ in range(M)]
    scalars[3][2] = 0
    want = [golden.g1_msm(pts, s) for s in scalars]
    ja = JAffine(JFQ.from_int([p[0] if p else 0 for p in pts]),
                 JFQ.from_int([p[1] if p else 0 for p in pts]),
                 jnp.asarray([p is None for p in pts]))
    js = JFR.from_int(scalars, mont=False)
    jgot = jg1.to_affine(jpp.msm_batched(jg1, ja, js, c, 4))
    assert g1.to_host(Affine(to_torch(jgot.x), to_torch(jgot.y), torch.from_numpy(np.array(jgot.inf)))) == want

    points = Affine(to_torch(ja.x), to_torch(ja.y), torch.from_numpy(np.array(ja.inf)))
    W = 256 // c + 1
    monkeypatch.setattr(budget, "STEP_BYTES", 2 * N * W * budget.SLOT_BYTES)
    assert pippenger._m_slices(M, N, W) == [(0, 2), (2, 4), (4, 5)]
    calls: list = []
    for name in ("make_plan", "bucket_sums", "_bucket_weighted_sum", "_window_combine"):
        _counting(monkeypatch, pippenger, name, calls)
    got = pippenger.msm_batched(points, to_torch(js), c)
    assert [calls.count(k) for k in ("make_plan", "bucket_sums", "_bucket_weighted_sum",
                                     "_window_combine")] == [3, 3, 1, 1]
    assert g1.to_host(g1.to_affine(got)) == want
    # one MSM whose N W alone exceeds the budget runs alone, cut along N
    # into slices of one point at the least
    monkeypatch.setattr(budget, "STEP_BYTES", 1)
    assert pippenger._m_slices(M, N, W) == [(i, i + 1) for i in range(M)]
    assert pippenger._n_slices(N, W) == [(i, i + 1) for i in range(N)]
    assert g1.to_host(g1.to_affine(pippenger.msm(points, to_torch(js[1]), c))) == want[1:2]


def test_sliced_s_at_y_batch_matches_jax(monkeypatch):
    """s(X, y_j) for m = 3 ys at n = 4, q = 5 with the products formed one q
    at a time: the same Montgomery integers as the port's uncut build and
    sonic_tpu's s_at_y_batched; over two stacked circuits, one y each, as
    sonic_tpu's proof-batch s_at_y_batch, and m ys each, as s_at_y_batched
    of each circuit."""
    rng = random.Random(12)
    n, q, m = 4, 5, 3
    circuits = [random_circuit(rng, n=n, q=q)[0] for _ in range(2)]
    ys = [[rng.randrange(1, R_MOD) for _ in range(m)] for _ in range(2)]
    jcs = [jcons.DeviceCircuit.from_host(c) for c in circuits]
    tcs = [DeviceCircuit.from_host(c, device="cpu") for c in circuits]
    whole = constraints.s_at_y_batch(tcs[0], FR.from_int(ys[0]))
    monkeypatch.setattr(budget, "STEP_BYTES", m * n * budget.PRODUCT_BYTES)
    calls: list = []
    _counting(monkeypatch, constraints.limb, "sum_mod", calls)
    got = constraints.s_at_y_batch(tcs[0], FR.from_int(ys[0]))
    assert calls.count("sum_mod") == 3 * q  # one q a slice, for each of wL, wR, wO
    assert torch.equal(got, whole)
    assert np.array_equal(np.asarray(jcons.s_at_y_batched(jcs[0], JFR.from_int(ys[0]))).astype(np.int64),
                          got.numpy())
    tst = constraints.stack_circuits(tcs)
    jgot = jcons.s_at_y_batch(jcons.stack_circuits(jcs), JFR.from_int([y[0] for y in ys]))
    assert np.array_equal(np.asarray(jgot).astype(np.int64),
                          constraints.s_at_y_batch(tst, FR.from_int([y[0] for y in ys])).numpy())
    got = constraints.s_at_y_batch(tst, FR.from_int(ys))  # (B, m, 3n+1, L)
    for b in range(2):
        jgot = jcons.s_at_y_batched(jcs[b], JFR.from_int(ys[b]))
        assert np.array_equal(np.asarray(jgot).astype(np.int64), got[b].numpy())


def test_sliced_s_at_u_batch_matches_jax(monkeypatch):
    """s(u, Y) at n = 4, q = 5 with its Y^(n+q) coefficients formed 2 q at
    a time (slices of 2, 2 and 1): the same Montgomery integers as the
    port's uncut build and sonic_tpu's s_at_u_of_y, and over two stacked
    circuits, one u each, as sonic_tpu's s_at_u_batch."""
    rng = random.Random(17)
    n, q = 4, 5
    circuits = [random_circuit(rng, n=n, q=q)[0] for _ in range(2)]
    us = [rng.randrange(1, R_MOD) for _ in range(2)]
    jcs = [jcons.DeviceCircuit.from_host(c) for c in circuits]
    tcs = [DeviceCircuit.from_host(c, device="cpu") for c in circuits]
    tst = constraints.stack_circuits(tcs)
    whole = constraints.s_at_u_batch(tst, FR.from_int(us))
    monkeypatch.setattr(budget, "STEP_BYTES", 2 * 2 * n * budget.PRODUCT_BYTES)
    calls: list = []
    _counting(monkeypatch, constraints.limb, "sum_mod", calls)
    got = constraints.s_at_u_batch(tst, FR.from_int(us))
    assert calls.count("sum_mod") == 3  # q slices of 2, 2 and 1
    assert torch.equal(got, whole)
    jgot = jcons.s_at_u_batch(jcons.stack_circuits(jcs), JFR.from_int(us))
    assert np.array_equal(np.asarray(jgot).astype(np.int64), got.numpy())
    one = constraints.s_at_u_of_y(tcs[1], FR.from_int(us[1]))
    jone = jcons.s_at_u_of_y(jcs[1], JFR.from_int(us[1]))
    assert one.offset == jone.offset == -n
    assert np.array_equal(np.asarray(jone.coeffs).astype(np.int64), one.coeffs.numpy())


def test_sliced_div_by_linear_batched_matches_jax(monkeypatch):
    """Five openings of one span, cut into slices of 2, 2 and 1 instances:
    the same evaluations and quotients as sonic_tpu's and the uncut call."""
    rng = random.Random(16)
    M, D, off = 5, 7, -3
    coeffs = [[rng.randrange(R_MOD) for _ in range(D)] for _ in range(M)]
    zs = [rng.randrange(1, R_MOD) for _ in range(M)]
    whole = laurent.div_by_linear_batched(off, FR.from_int(coeffs), FR.from_int(zs))
    monkeypatch.setattr(budget, "STEP_BYTES", 2 * D * budget.COEFF_BYTES)
    got = laurent.div_by_linear_batched(off, FR.from_int(coeffs), FR.from_int(zs))
    jgot = jlaurent.div_by_linear_batched(off, JFR.from_int(coeffs), JFR.from_int(zs))
    for j, w, g in zip(jgot, whole, got):
        assert torch.equal(g, w)
        assert np.array_equal(np.asarray(j).astype(np.int64), g.numpy())


def _native_g1_mul(p, k):
    return jnative.g1_msm_native([p], [k % gp.P])


def _host_srs(d, x, alpha):
    """The golden SRS's G1 tables (golden_protocol.SRS.new's, without the
    G2 ones prove does not read), each row one native host
    multiplication of the JAX package."""
    P, xinv, g = gp.P, pow(x, -1, gp.P), golden.G1_GEN
    neg = [pow(xinv, i, P) for i in range(1, d + 1)]
    pos = [pow(x, i, P) for i in range(d + 1)]
    return jgp.SRS(
        d=d,
        g_neg_x=[_native_g1_mul(g, e) for e in neg],
        g_pos_x=[_native_g1_mul(g, e) for e in pos],
        h_neg_x=[], h_pos_x=[],
        g_neg_ax=[_native_g1_mul(g, alpha * e) for e in neg],
        g_pos_ax=[_native_g1_mul(g, alpha * e) for e in pos[1:]],
        h_neg_ax=[], h_pos_ax=[],
    )


# the circuits' size: d = 7 n = 56
TINY_N = 8
# one and a half q-slices of the s(X, y_j) build's products at n = 8 with
# 2 instances (m ys, or B circuits of m ys each): one q a slice; every
# batched MSM over 6 or more points, every batched division over 12 or
# more coefficients and every helper slice of more than one proof or
# instance then runs one instance (one proof) a slice, and every MSM over
# 6 or more points is cut along N
TINY_STEP = 3 * 2 * TINY_N * budget.PRODUCT_BYTES // 2


def _tiny_budget_setup(monkeypatch, seed, B, q):
    """B random circuits at n = TINY_N and q, their randomness, a host
    SRS and its upload, the step budget at TINY_STEP, and the golden
    proofs' bytes (the golden prover's multiplications through the JAX
    package's native host MSM)."""
    assert jnative.get_lib() is not None
    monkeypatch.setattr(golden, "g1_mul", _native_g1_mul)
    rng = random.Random(seed)
    n = TINY_N
    pairs = [random_circuit(rng, n=n, q=q) for _ in range(B)]
    rnds = [gp.Randomness.generate(rng, q) for _ in range(B)]
    host = _host_srs(7 * n, rng.randrange(2, gp.P), rng.randrange(2, gp.P))
    srs = SRS.from_host(host, device="cpu")
    dcs = [DeviceCircuit.from_host(c, device="cpu") for c, _ in pairs]
    das = [DeviceAssignment.from_host(a, device="cpu") for _, a in pairs]
    monkeypatch.setattr(budget, "STEP_BYTES", TINY_STEP)
    wants = [jserial.proof_to_bytes(jgp.prove(host, a, c, jgp.Randomness(**vars(r)))[0])
             for (c, a), r in zip(pairs, rnds)]
    return srs, dcs, das, rnds, wants


@pytest.mark.parametrize("batch", [False, True], ids=["prove", "prove_batch"])
def test_prove_with_tiny_budgets_matches_golden(monkeypatch, batch):
    """prove at n = 8, q = 2, and prove_batch of B = 2 circuits at q = 2,
    with a tiny step budget: the batch's helper streams over 2 slices of
    one proof (protocol.helper_slicings), so each batched MSM of the helper
    has M = q, and every batched MSM of M = q (in the batch also zkP's, over
    the B = 2 proofs) runs one MSM a slice; prove's helper runs one of its
    q instances a slice (signature.slicings); every MSM over 6 or more
    points is cut along N (pippenger.n_slicings), as breakdown's table of
    slicings shows, with a bucket-sums call for each slice of M and of N;
    the batch's batched divisions run in slices; the proofs are byte-equal
    to the golden prover's."""
    B, q = (2, 2) if batch else (1, 2)
    srs, dcs, das, rnds, wants = _tiny_budget_setup(monkeypatch, 14 if batch else 13, B, q)
    calls: list = []
    _counting(monkeypatch, pippenger, "bucket_sums", calls)
    _counting(monkeypatch, laurent, "div_by_linear_batched", calls)  # its slices only
    shapes: list = []  # (M, N) of every MSM batch
    real_windows = pippenger._windows

    def windows(points, sc, *args):
        shapes.append((sc.shape[0] if sc.dim() == 3 else 1, sc.shape[-2]))
        return real_windows(points, sc, *args)

    monkeypatch.setattr(pippenger, "_windows", windows)
    phases = breakdown.PHASES + (breakdown.BATCH_PHASES if batch else [])
    before = collections.Counter(protocol.helper_slicings), collections.Counter(signature.slicings)
    with breakdown.phase_timers(torch.device("cpu"), phases) as acc:
        if batch:
            proofs = [p for p, _ in protocol.prove_batch(srs, das, dcs, rnds)]
        else:
            proofs = [protocol.prove(srs, das[0], dcs[0], rnds[0])[0]]
    assert [serial.proof_to_bytes(p) for p in proofs] == wants
    assert protocol.helper_slicings - before[0] == ({(B, B): 1} if batch else {})
    assert signature.slicings - before[1] == ({} if batch else {(q, TINY_N, q): 1})
    helper = [key for key in acc.slices if key[0] == q]
    assert all(k == M for M, _, k in acc.slices)
    assert bool(helper) == batch  # prove's helper slices have one instance
    assert acc.nslices and all(N >= 6 and k > 1 for _, N, k in acc.nslices)
    launches = 0
    for M, N in shapes:
        W = -(-256 // pippenger._pick_c(N, "cpu")) + 1
        launches += len(pippenger._m_slices(M, N, W)) * len(pippenger._n_slices(N, W))
    assert calls.count("bucket_sums") == launches > len(shapes)
    assert (calls.count("div_by_linear_batched") > 0) == batch  # prove's have one instance


def test_msm_g2_matches_golden():
    """msm_g2 (and msm with group=g2, batched) at N = 8, c = 4 with an
    infinity point and zero and one scalars: the sum of golden.g2_mul."""
    rng = random.Random(14)
    N = 8
    pts = [golden.g2_mul(golden.G2_GEN, rng.randrange(1, R_MOD)) for _ in range(N)]
    pts[2] = None
    scalars = [[rng.randrange(R_MOD) for _ in range(N - 2)] + [0, 1] for _ in range(2)]
    want = []
    for s in scalars:
        acc = None
        for p, k in zip(pts, s):
            acc = golden.g2_add(acc, golden.g2_mul(p, k) if p is not None else None)
        want.append(acc)
    points = g2.from_host(pts, "cpu")
    sc = FR.from_int(scalars, mont=False)
    got = pippenger.msm_g2(points, sc[0], 4)
    assert got.x.shape == (2, FQ.nlimbs)
    assert g2.to_host(g2.to_affine(got.map(lambda a: a[None]))) == want[:1]
    batch = pippenger.msm_batched(points, sc, 4, group=g2)
    assert g2.to_host(g2.to_affine(batch)) == want
    two = pippenger.msm_g1(g1.from_host([golden.G1_GEN] * 2, "cpu"), sc[0, :2], 4)
    assert g1.to_host(g1.to_affine(two.map(lambda a: a[None]))) == [
        golden.g1_mul(golden.G1_GEN, (scalars[0][0] + scalars[0][1]) % R_MOD)]


def test_laurent_zero_and_neg_match_jax():
    rng = random.Random(15)
    vals = [rng.randrange(R_MOD) for _ in range(5)] + [0]
    p = laurent.Laurent(-2, FR.from_int(vals))
    jp = jlaurent.Laurent(-2, JFR.from_int(vals))
    jn, tn = jlaurent.neg(jp), laurent.neg(p)
    assert jn.offset == tn.offset
    assert np.array_equal(np.asarray(jn.coeffs).astype(np.int64), tn.coeffs.numpy())
    assert laurent.add(p, tn).to_terms() == {}
    jz, tz = jlaurent.zero(), laurent.zero()
    assert (jz.offset, jz.length) == (tz.offset, tz.length)
    assert np.array_equal(np.asarray(jz.coeffs).astype(np.int64), tz.coeffs.numpy())
    assert laurent.add(p, tz).to_terms() == p.to_terms()


@pytest.mark.parametrize("mont", [True, False])
def test_from_int_matches_jax(mont):
    """The byte-wise conversion on negatives, values >= the modulus, a
    scalar, nested lists and an empty list, in both fields."""
    for spec, jspec in ((FR, JFR), (FQ, JFQ)):
        for v in (0, -1, spec.modulus + 5, [[1, 2, -3], [spec.modulus - 1, 7, 1 << 300]]):
            want = np.asarray(jspec.from_int(v, mont=mont)).astype(np.int64)
            got = spec.from_int(v, mont=mont)
            assert got.shape == want.shape and np.array_equal(got.numpy(), want)
        assert tuple(spec.from_int([], mont=mont).shape) == (0, spec.nlimbs)
