"""PyTorch port on an NVIDIA card: each CUDA kernel against its plain
version on the same CUDA tensors (kernel 3, the MSM tail, at the main
path's shapes and in a prove; kernel 4, the openings' division, at its
edge shapes and the helper's), the pinned example2 proof on the card,
a proof batch and a full SRS on the card against their CPU results, and
a sharded prove (a rank a card, or two ranks sharing the one card)
against the single-rank one.

Every test here needs a CUDA device; it skips elsewhere. This file imports
neither jax nor sonic_tpu, and the card's machine has no jax, so run it
there without the repository's conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

All comparisons are exact (every value is an integer).
"""
import dataclasses
import json
import os
import random

import pytest
import torch

from sonic_tpu_torch import golden, protocol, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import example_circuit_2, random_circuit
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.curve.group import Affine, g1, g2
from sonic_tpu_torch.fields import limb, mont_mul
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FQ, FR
from sonic_tpu_torch.msm import bucket_acc, pippenger, tail
from sonic_tpu_torch.poly import div, laurent
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
    # an operand whose data starts 8 bytes past a 16-byte boundary
    odd = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape)
    assert odd.data_ptr() % 16 == 8
    assert torch.equal(mont_mul.mont_mul(odd, b, spec), got)
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


@pytest.mark.parametrize("batch", [None, 3, 64], ids=["single", "batched", "batched64"])
def test_bucket_acc_kernel_equals_plain(dev, batch):
    """Bucket sums over N=40 points (two at infinity), W=3 windows, c=4 (9
    buckets), digits of both signs and zeros, at the device's chunk count
    and with chunks of 3 entries (buckets cut across chunks): the whole
    (M, W, B) output, bit for bit, against bucket_sums_plain on the same plan."""
    N, W, nb = 40, 3, 9
    pts = _points(random.Random(32), N, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    shape = (N, W) if batch is None else (batch, N, W)
    digits = torch.randint(-(nb - 1), nb, shape, generator=gen, device=dev)
    for chunks in (None, -(-int((digits != 0).sum()) // 3)):
        plan = bucket_acc.make_plan(pts.inf, digits, nb, chunks)
        before = bucket_acc.launches
        got = bucket_acc.bucket_sums(pts, plan)
        assert bucket_acc.launches == before + 1
        want = bucket_acc.bucket_sums_plain(pts, plan)
        assert got.x.shape == (batch or 1, W, nb, FQ.nlimbs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        cpu = bucket_acc.bucket_sums_plain(Affine(*(a.cpu() for a in pts)), plan.to("cpu"))
        for g, w in zip(got, cpu):
            assert torch.equal(g.cpu(), w)


def _grid(rng, R, K, dev, special=None):
    """G1 points (R, K) on the card in projective form: host points from a
    pool of 24 and infinity, some rows set by `special(rows, pool)`, each
    point scaled by a random nonzero lambda (infinity becomes (0 : lambda
    : 0)). Also returns the host rows."""
    pool = [golden.g1_mul(golden.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(24)] + [None]
    rows = [[rng.choice(pool) for _ in range(K)] for _ in range(R)]
    if special is not None:
        special(rows, pool)
    flat = [p for row in rows for p in row]
    base = g1.from_affine(g1.from_host(flat, dev))
    lam = FQ.from_int([rng.randrange(1, FQ.modulus) for _ in flat], device=dev)
    return base.map(lambda a: limb.mul(a, lam, FQ).reshape(R, K, FQ.nlimbs)), rows


def _host_sum(terms):
    acc = None
    for p, k in terms:
        if p is not None:
            acc = golden.g1_add(acc, golden.g1_mul(p, k))
    return acc


@pytest.mark.parametrize("R, W, c", [(263, 44, 6), (624, 44, 6), (5, 3, 2), (4, 1, 16)])
def test_window_combine_kernel_equals_plain(dev, R, W, c):
    """Kernel 3's window combine bit for bit, in projective form, against
    window_combine_plain at the prove's (R = 263) and prove_batch's
    (R = 624) shapes and small ones: row 0 all at infinity, row 1 with
    totals[W-2] = 2^c totals[W-1] (the first addition meets P + P), row 2
    every window equal, and infinity among the other totals. Rows 0-2 also
    against the golden host sums."""
    rng = random.Random(1000 * R + W)

    def special(rows, pool):
        rows[0] = [None] * W
        if W > 1:
            rows[1][W - 1], rows[1][W - 2] = pool[0], golden.g1_mul(pool[0], 1 << c)
        rows[2] = [pool[1]] * W

    totals, rows = _grid(rng, R, W, dev, special)
    before = tail.launches
    got = tail.window_combine(totals, c)
    assert tail.launches == before + 1
    assert got.x.shape == (R, FQ.nlimbs)
    want = tail.window_combine_plain(totals, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(pippenger._window_combine(totals, c), got):
        assert torch.equal(g, w)
    assert tail.launches == before + 2
    host = g1.to_host(g1.to_affine(got.map(lambda a: a[:3])))
    assert host == [_host_sum((p, 1 << (c * w)) for w, p in enumerate(rows[r])) for r in range(3)]


@pytest.mark.parametrize("M", [64, 1])
def test_bucket_weighted_sum_kernel_equals_plain(dev, M):
    """Kernel 3's weighted sum against bucket_weighted_sum_plain as group
    elements (after to_affine) over M MSMs' (W = 44, B = 33) bucket sums:
    empty buckets throughout, row 0 all at infinity, row 1 with only
    bucket 0 (which the sum skips) finite. Rows 0-2 also against the
    golden host sums."""
    W, B = 44, 33
    rng = random.Random(2000 + M)

    def special(rows, pool):
        rows[0] = [None] * B
        rows[1] = [pool[0]] + [None] * (B - 1)

    flat, rows = _grid(rng, M * W, B, dev, special)
    buckets = flat.map(lambda a: a.reshape(M, W, B, FQ.nlimbs))
    before = tail.launches
    got = pippenger._bucket_weighted_sum(buckets)
    assert tail.launches == before + 1
    assert got.x.shape == (M, W, FQ.nlimbs)
    want = tail.bucket_weighted_sum_plain(buckets)
    for g, w in zip(g1.to_affine(got), g1.to_affine(want)):
        assert torch.equal(g, w)
    host = g1.to_host(g1.to_affine(got.map(lambda a: a.reshape(-1, FQ.nlimbs)[:3])))
    assert host == [_host_sum((p, b) for b, p in enumerate(rows[r]) if b) for r in range(3)]


def test_tail_kernel_rejects_what_it_does_not_take(dev):
    totals, _ = _grid(random.Random(3), 2, 3, dev)
    odd = totals.map(lambda a: torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape))
    assert odd.x.data_ptr() % 16 == 8
    bad = [
        (ValueError, totals.map(lambda a: a.transpose(0, 1))),
        (ValueError, odd),
        (ValueError, totals.map(lambda a: a.cpu())),
        (ValueError, totals.map(lambda a: a[..., :16])),
        (TypeError, totals.map(lambda a: a.to(torch.int32))),
    ]
    before = tail.launches
    for err, p in bad:
        with pytest.raises(err):
            tail.window_combine(p, 6)
        with pytest.raises(err):
            tail.bucket_weighted_sum(p)
    with pytest.raises(ValueError):
        tail.window_combine(totals, 17)
    assert tail.launches == before


def _host_division(c, z, offset):
    """f(z) and the quotient of (f(X) - f(z)) / (X - z) in Python ints,
    top-down (z^offset through the inverse, 0 at z = 0 as inv(0) = 0)."""
    zo = pow(pow(z, R_MOD - 2, R_MOD), -offset, R_MOD) if offset < 0 else pow(z, offset, R_MOD)
    acc = 0
    for ci in reversed(c):
        acc = (acc * z + ci) % R_MOD
    fz = zo * acc % R_MOD
    ch = list(c)
    if 0 <= -offset < len(c):
        ch[-offset] = (ch[-offset] - fz) % R_MOD
    w = [0] * (len(c) - 1)
    acc = 0
    for i in range(len(c) - 1, 0, -1):
        acc = (acc * z + ch[i]) % R_MOD
        w[i - 1] = acc
    return fz, w


def _plain_division(offset, coeffs, zs, per):
    """The plain version on the same tensors, `per` instances at a time."""
    outs = [laurent.div_by_linear_batched_plain(offset, coeffs[i : i + per], zs[i : i + per])
            for i in range(0, coeffs.shape[0], per)]
    return torch.cat([f for f, _ in outs]), torch.cat([w for _, w in outs])


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("M, D, pos, edge", [
    (3, 5, 2, "D below one chunk"),
    (4, 2, 1, "D = 2"),
    (4, 2, 0, "D = 2, X^0 first"),
    (5, 67, 16, "D not a multiple of K, X^0 first in its chunk"),
    (5, 67, 31, "D not a multiple of K, X^0 last in its chunk"),
    (2, 4101, 2048, "X^0 first in a block of chunks"),
    (2, 4101, 2047, "X^0 last in a block of chunks"),
    (64, 3073, 2049, "M = 64 at D = 3n + 1, n = 1024"),
    (1, 458_757, 131_077, "M = 1, thousands of chunks"),
    (64, 196_609, 131_073, "M = 64 at D = 3n + 1, n = 2^16"),
])
def test_poly_div_kernel_equals_plain(dev, M, D, pos, edge):
    """Kernel 4 (`laurent.div_by_linear_batched` on CUDA tensors) byte for
    byte against the plain version on the same tensors, and, for the small
    shapes and two instances of the large ones, against the division in
    Python ints; no kernel-1 launch for the division itself."""
    K = div.chunk_len(M, D, _sms(dev))
    if "below" in edge:
        assert D < K
    if "multiple" in edge:
        assert D % K and pos % K == (0 if "first" in edge else K - 1)
    if "block" in edge:
        assert pos % (K * div.BLOCK) == (0 if "first" in edge else K * div.BLOCK - 1)
    if "thousands" in edge:  # more blocks of chunks than the carry pass has threads
        assert -(-D // K) > div.BLOCK ** 2
    g = torch.Generator(device=dev).manual_seed(D + pos)
    coeffs = torch.randint(0, 1 << 16, (M, D, FR.nlimbs), generator=g, device=dev)
    coeffs[..., -1] = torch.randint(0, FR.mod_limbs[-1], (M, D), generator=g, device=dev)
    rng = random.Random(D)
    zs = FR.from_int([rng.randrange(1, R_MOD) for _ in range(M)], device=dev)
    before, k1 = div.launches, mont_mul.launches
    fz, w = laurent.div_by_linear_batched(-pos, coeffs, zs)
    torch.cuda.synchronize()
    slices = -(-M // laurent.budget.per_step(laurent.budget.COEFF_BYTES * D))
    assert div.launches - before == slices and mont_mul.launches == k1
    assert fz.shape == (M, FR.nlimbs) and w.shape == (M, D - 1, FR.nlimbs)
    pfz, pw = _plain_division(-pos, coeffs, zs, 16)
    assert torch.equal(fz, pfz) and torch.equal(w, pw)
    for j in ([0, M - 1] if D > 100 else range(M)):
        c = FR.to_int(coeffs[j].cpu())
        hfz, hw = _host_division([int(v) for v in c], FR.to_int(zs[j].cpu()), -pos)
        assert FR.to_int(fz[j].cpu()) == hfz
        if D <= 100:
            assert [int(v) for v in FR.to_int(w[j].cpu())] == hw
        else:  # the ends of the quotient and around X^0
            idx = [0, 1, pos - 1, pos, pos + 1, D - 3, D - 2]
            got = FR.to_int(w[j, idx].cpu())
            assert [int(v) for v in got] == [hw[i] for i in idx]


@pytest.mark.parametrize("offset", [0, -3, 2])
def test_poly_div_kernel_at_zero(dev, offset):
    """z = 0 among the points: the quotient equals `_div_linear_seq` (the
    closed form is wrong there), f(0) the plain version's (0 for a negative
    offset, inv(0) = 0). At offset 2, X^0 lies outside the span: nothing
    is subtracted, and the single form checks f(z) = 0 (true at z = 0,
    false elsewhere)."""
    rng = random.Random(50 - offset)
    M, D = 3, 21
    rows = [[rng.randrange(R_MOD) for _ in range(D)] for _ in range(M)]
    zs_int = [0, rng.randrange(1, R_MOD), 0]
    coeffs, zs = FR.from_int(rows, device=dev), FR.from_int(zs_int, device=dev)
    fz, w = div.divide(offset, coeffs, zs)
    for j in range(M):
        hfz, hw = _host_division(rows[j], zs_int[j], offset)
        assert FR.to_int(fz[j].cpu()) == hfz
        assert [int(v) for v in FR.to_int(w[j].cpu())] == hw
        want_fz = laurent.evaluate_batched(offset, coeffs[j : j + 1].cpu(), zs[j : j + 1].cpu())
        assert torch.equal(fz[j : j + 1].cpu(), want_fz)
        if zs_int[j] == 0:
            chat = coeffs[j].cpu().clone()
            if 0 <= -offset < D:
                chat[-offset] = limb.sub(chat[-offset], want_fz[0], FR)
            assert torch.equal(w[j].cpu(), laurent._div_linear_seq(chat, FR.zeros()))
    p = laurent.Laurent(offset, coeffs[0])
    if offset <= 0:
        sfz, sw = laurent.div_by_linear(p, zs[0])
        assert torch.equal(sfz, fz[0]) and torch.equal(sw.coeffs, w[0])
    else:
        sfz, sw = laurent.div_by_linear(p, zs[0])  # f(0) = 0 at offset > 0
        assert torch.equal(sfz, fz[0]) and sw.offset == offset
        with pytest.raises(ValueError):
            laurent.div_by_linear(laurent.Laurent(offset, coeffs[1]), zs[1])


def test_poly_div_single_form_equals_the_cpu(dev):
    """`laurent.div_by_linear` on the card: one kernel-4 call, no kernel-1
    launch, the CPU's outputs; a given f(z) is taken as it is."""
    rng = random.Random(61)
    f = {e: rng.randrange(R_MOD) for e in range(-700, 1300)}
    p = laurent.Laurent.from_terms(f)
    z = FR.from_int(rng.randrange(1, R_MOD))
    before, k1 = div.launches, mont_mul.launches
    fz, w = laurent.div_by_linear(laurent.Laurent(p.offset, p.coeffs.to(dev)), z.to(dev))
    assert div.launches == before + 1 and mont_mul.launches == k1
    cfz, cw = laurent.div_by_linear(p, z)
    assert torch.equal(fz.cpu(), cfz) and w.offset == cw.offset and torch.equal(w.coeffs.cpu(), cw.coeffs)
    other = FR.from_int(rng.randrange(R_MOD))
    gfz, gw = laurent.div_by_linear(laurent.Laurent(p.offset, p.coeffs.to(dev)), z.to(dev), fz=other.to(dev))
    cfz, cw = laurent.div_by_linear(p, z, fz=other)
    assert torch.equal(gfz.cpu(), cfz) and torch.equal(gw.coeffs.cpu(), cw.coeffs)


def test_poly_div_kernel_rejects_what_it_does_not_take(dev):
    coeffs = FR.from_int([[1, 2, 3]], device=dev)
    zs = FR.from_int([5], device=dev)
    before = div.launches
    for args in [(0, coeffs.cpu(), zs.cpu()), (0, coeffs[:, :0], zs), (0, coeffs, zs[:, :8]),
                 (0, coeffs.to(torch.int32), zs), (0, coeffs[0], zs), (0, coeffs, zs.repeat(2, 1))]:
        with pytest.raises(ValueError):
            div.divide(*args)
    assert div.launches == before


@pytest.mark.parametrize("n, q", [(1024, 64), (16, 8)])
def test_prove_on_the_card_runs_kernel_3(dev, monkeypatch, n, q):
    """protocol.prove on the card, kernel 3 launched once for each weighted
    sum and each window combine the prove asks for. At the main path's
    n = 1024, q = 64 (the tail's shapes, R = 4m + 7 = 263 and the helper's
    M = 64, do not depend on n) byte-equal to the card's prove with the
    plain tail; at n = 16, q = 8 byte-equal to the CPU's prove (the CPU
    takes minutes at q = 64, over ten at n = 1024). The G2 MSMs of msm_g2
    launch no kernel 3."""
    rng = random.Random(42)
    circuit, assignment = random_circuit(rng, n=n, q=q)
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    rnd = gp.Randomness.generate(rng, m=q)
    srs = SRS.new(7 * n + 20, x, alpha, h_mode="verifier", n_hints=[n], device=dev)
    calls = []
    for name in ("_bucket_weighted_sum", "_window_combine"):
        real = getattr(pippenger, name)
        monkeypatch.setattr(pippenger, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))

    def run(device):
        on = dataclasses.replace(srs, g_x=Affine(*(a.to(device) for a in srs.g_x)),
                                 g_ax=Affine(*(a.to(device) for a in srs.g_ax)))
        proof, _ = protocol.prove(on, DeviceAssignment.from_host(assignment, device=device),
                                  DeviceCircuit.from_host(circuit, device=device), rnd)
        return serial.proof_to_bytes(proof)

    before = tail.launches
    got = run(dev)
    card = len(calls)
    assert tail.launches - before == card and calls.count("_window_combine") == 1
    if q == 64:
        monkeypatch.setattr(tail, "bucket_weighted_sum", tail.bucket_weighted_sum_plain)
        monkeypatch.setattr(tail, "window_combine", tail.window_combine_plain)
        assert run(dev) == got
    else:
        assert run("cpu") == got
    assert tail.launches - before == card
    g2_host = [golden.g2_mul(golden.G2_GEN, k) for k in (3, 5)]
    pippenger.msm_g2(g2.from_host(g2_host, dev), FR.from_int([7, 11], mont=False, device=dev))
    assert tail.launches - before == card


def _example2():
    with open(VEC_PATH) as f:
        vec = json.load(f)["example2"]
    r = vec["rnd"]
    rnd = gp.Randomness(cns=r["cns"], y=r["y"], z=r["z"], ys=r["ys"], zs=r["zs"], u=r["u"], v=r["v"])
    circuit, assignment = example_circuit_2(x=1, z=2)
    return gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"]), circuit, assignment, rnd, vec["proof_hex"]


def test_pinned_example2_proof_on_the_card(dev):
    host_srs, circuit, assignment, rnd, proof_hex = _example2()
    srs = SRS.from_host(host_srs, device=dev)
    dc = DeviceCircuit.from_host(circuit, device=dev)
    da = DeviceAssignment.from_host(assignment, device=dev)
    mont_mul.launches = bucket_acc.launches = div.launches = 0
    proof, oracle = protocol.prove(srs, da, dc, rnd)
    assert mont_mul.launches > 0 and bucket_acc.launches > 0 and div.launches > 0
    assert serial.proof_to_bytes(proof).hex() == proof_hex
    assert protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)


def test_prove_batch_on_the_card_equals_the_cpu(dev):
    """B=3, n=3, q=2 (the CPU test's shapes): the same proof bytes on the
    card as on the CPU, through both kernels."""
    rng = random.Random(77)
    host_srs = gp.SRS.new(26, x=rng.randrange(2, gp.P), alpha=rng.randrange(2, gp.P))
    pairs = [random_circuit(rng, n=3, q=2) for _ in range(3)]
    rnds = [gp.Randomness.generate(rng, m=2) for _ in pairs]

    def run(device):
        return protocol.prove_batch(
            SRS.from_host(host_srs, device=device),
            [DeviceAssignment.from_host(a, device=device) for _, a in pairs],
            [DeviceCircuit.from_host(c, device=device) for c, _ in pairs],
            rnds,
        )

    mont_mul.launches = bucket_acc.launches = 0
    got = run(dev)
    assert mont_mul.launches > 0 and bucket_acc.launches > 0
    want = run("cpu")
    assert [serial.proof_to_bytes(p) for p, _ in got] == [serial.proof_to_bytes(p) for p, _ in want]


def test_full_srs_new_on_the_card_equals_the_cpu(dev):
    """SRS.new(h_mode="full") at d=8: all four tables (G2 over Fq2) equal
    limb for limb to the CPU's."""
    d, x, alpha = 8, 987654321, 123456789
    mont_mul.launches = 0
    got = SRS.new(d, x, alpha, h_mode="full", device=dev)
    assert mont_mul.launches > 0
    want = SRS.new(d, x, alpha, h_mode="full", device="cpu")
    for name in ("g_x", "g_ax", "h_x", "h_ax"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert torch.equal(a.cpu(), b), name


def _card_ranks(rank, world, store, outdir, backend):
    """One rank: prove(mesh) on example2, on card rank % card count."""
    from test_torch_parallel import save_rank

    from sonic_tpu_torch.parallel import distributed

    os.environ["LOCAL_RANK"] = str(rank)
    distributed.initialize(backend=backend, init_method=f"file://{store}", world_size=world, rank=rank)
    host_srs, circuit, assignment, rnd, _ = _example2()
    dev = torch.device("cuda")
    srs, dc = SRS.from_host(host_srs, device=dev), DeviceCircuit.from_host(circuit, device=dev)
    mont_mul.launches = bucket_acc.launches = 0
    proof, oracle = protocol.prove(srs, DeviceAssignment.from_host(assignment, device=dev), dc, rnd,
                                   mesh=distributed.global_mesh())
    launches = (mont_mul.launches, bucket_acc.launches)
    ok = protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
    save_rank(outdir, rank, (serial.proof_to_bytes(proof), launches, ok))


def test_sharded_prove_on_the_card_equals_prove(dev, tmp_path):
    """One rank a card over NCCL where there are several cards, else two
    ranks sharing the card over gloo (NCCL refuses two ranks on one GPU);
    each rank's proof equals the single-rank prove's, and both kernels ran
    on each rank."""
    from test_torch_parallel import run_world

    cards = torch.cuda.device_count()
    world, backend = (cards, "nccl") if cards >= 2 else (2, "gloo")
    wait = run_world(_card_ranks, world, tmp_path, backend)
    host_srs, circuit, assignment, rnd, proof_hex = _example2()
    want, _ = protocol.prove(SRS.from_host(host_srs, device=dev),
                             DeviceAssignment.from_host(assignment, device=dev),
                             DeviceCircuit.from_host(circuit, device=dev), rnd)
    assert serial.proof_to_bytes(want).hex() == proof_hex
    for got, (k1, k2), ok in wait():
        assert got == serial.proof_to_bytes(want)
        assert k1 > 0 and k2 > 0 and ok is True
