"""Where one prove spends its time: phase timers and a device profile.
With BATCH_PHASES, the timers cover `prove_batch` too.

    python -m sonic_tpu_torch.breakdown [--device cuda] [--n 1024] [--q 64]
                                        [--seed 42] [--reps 3] [--batch B]
                                        [--profiler] [--check]

Sets up what `example.py --n N --q Q` sets up (random_circuit(Random(seed),
n, q), d = 7n + 20, the verifier-mode SRS built on the device), proves once
to warm up and times `reps` proves. With --batch B, each prove is one
`prove_batch` of B such circuits (one random_circuit each, as bench.py's
batch), timed with PHASES + BATCH_PHASES, and the helper's slices of the
proofs are printed too. Then it proves once more with a
synchronizing timer around each phase function of the prover and prints,
per phase, its seconds, its calls, the kernel-1 launches made inside it
and its peak device memory, how many slices of the M axis each shape
of batched MSM was cut into and of the N axis each MSM cut along its
points (`budget`, `pippenger.slicings`, `pippenger.n_slicings`), and the
helper's slices of its instances (`signature.slicings`). Rows that start
with "in" are nested inside the phases above them. With
--profiler, one more prove runs under torch.profiler, and the device's
events, busy seconds, busy share of the wall and busiest kernels are
printed (on the CPU there are no device events).

With --check (one process, one prove a call), the run is also held to
what a prove must give: every prove the same bytes (their sha256 is
printed, to compare with `multichip`'s), the timed proves' peak device
memory within HUGE_PEAK_GIB (the SRS and the circuit included), verify
True and False once tampered (timed), pr_r and pr_t equal to native host
MSMs over the same SRS rows (`native_msm`), and rows of both SRS tables
(random ones, e = -d, 0, d, both sides of every fixed-base chunk
boundary) equal to golden.g1_mul; the SRS set-up and the upload are
timed. BASELINE config 4 at its own size on one card:

    python -m sonic_tpu_torch.breakdown --gates 1048576 --q 64 --seed 20 --reps 1 --check

Under torchrun (WORLD_SIZE > 1) every rank builds the SRS and proves with
the mesh of all ranks, the timers cover the collectives too
(PARALLEL_PHASES), and rank 0 prints:

    torchrun --nproc_per_node=K -m sonic_tpu_torch.breakdown --gates 1024 --q 64

The timers replace module attributes for the duration of one prove and put
them back afterwards; they add a device synchronize per call.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import hashlib
import os
import random
import statistics
import sys
import time

import numpy as np
import torch

from . import commitment, golden, native, protocol, serial, signature
from . import golden_protocol as gp
from .circuit import random_circuit
from .constraints import (DeviceAssignment, DeviceCircuit, k_at_y, r_at_y, r_x1_poly,
                          s_at_y)
from .curve.group import Affine, g1
from .fields import limb, mont_mul
from .fields.limb import FQ, FR
from .msm import fixed_base, pippenger
from .parallel import distributed, ntt_sharded
from .parallel import mesh as pmesh
from .poly import laurent
from .srs import SRS

# --check: the most device memory one prove may allocate at BASELINE
# config 4's size (n = 2^20, q = 64), the SRS and the circuit on the card
# included: 25.8 GB of circuit, 11.3 GB of SRS, the rest the step budget's
HUGE_PEAK_GIB = 70.0
SRS_ROWS_CHECKED = 24  # --check: random rows a table against golden.g1_mul

# (module, attribute, label): the prover's phase functions as the prover
# looks them up
PHASES = [
    (protocol, "r_x1_poly", "build r/s/k"),
    (protocol, "r_at_y", "build r/s/k"),
    (protocol, "s_at_y", "build r/s/k"),
    (protocol, "k_at_y", "build r/s/k"),
    (protocol.laurent, "mul", "t = r1 (r + s)"),
    (protocol, "commit_poly", "commit r, t (zkP_1/2)"),
    (protocol, "open_poly", "3 openings (zkP_3)"),
    (protocol, "evaluate", "s(z, y)"),
    (protocol, "hsc_prove_device", "helper (hsc)"),
    (protocol, "combine_windows", "window combine, all MSMs"),
    (protocol, "jacobians_to_host", "to_affine + fetch"),
    (pippenger, "_lay_out", "in MSMs: digits + layout"),
    (pippenger, "make_plan", "in MSMs: bucket plan"),
    (pippenger, "bucket_sums", "in MSMs: bucket sums (kernel 2)"),
    (pippenger, "_bucket_weighted_sum", "in MSMs: bucket weighted sum"),
    (commitment, "div_by_linear", "in openings: div_by_linear"),
    (commitment, "div_by_linear_batched", "in openings: div_by_linear_batched"),
    (signature, "s_at_y_batched", "in helper: s(X, y_j) build"),
    (signature, "s_at_u_of_y", "in helper: s(u, Y) build"),
]

# prove_batch's own phase functions (the helper's B*m instances run in the
# same calls, a slice of the proofs at a time); PHASES' MSM rows time what
# runs inside them
BATCH_PHASES = [
    (protocol, "r_x1_batch", "batch: builds r/s/k, s(X,y_j), s(u,Y)"),
    (protocol, "r_at_y_batch", "batch: builds r/s/k, s(X,y_j), s(u,Y)"),
    (protocol, "s_at_y_batch", "batch: builds r/s/k, s(X,y_j), s(u,Y)"),
    (protocol, "k_at_y_batch", "batch: builds r/s/k, s(X,y_j), s(u,Y)"),
    (protocol, "s_at_u_batch", "batch: builds r/s/k, s(X,y_j), s(u,Y)"),
    (protocol.laurent, "mul_batched", "t = r1 (r + s)"),
    (protocol, "commit_poly_batched", "batch: commits (r, t, helper)"),
    (protocol, "open_poly_batched", "batch: openings (zkP_3, helper)"),
]

# the collectives of a call with a mesh (parallel/), as their callers look
# them up; nested in the phases above, and a collective's seconds include
# waiting for the slowest rank
PARALLEL_PHASES = [
    (pmesh, "all_gather_rows", "in comms: all_gather (MSM, SRS rows)"),
    (ntt_sharded, "all_gather_rows", "in comms: all_gather (NTT output)"),
    (ntt_sharded, "all_to_all_rows", "in comms: all_to_all_single (NTT)"),
]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timings(collections.defaultdict):
    """{label: [seconds, calls, kernel-1 launches, peak device bytes]};
    `slices` counts the batched MSMs' calls by (M, N, slices of M),
    `nslices` the MSMs' calls cut along N by (M, N, slices of N),
    `instances` the helper's calls by (m, n, slices of its instances),
    `helper` prove_batch's calls by (B, the helper's slices of the proofs),
    and `peak` is the most device memory allocated at any time inside the
    block since the allocator's peak was last reset before it (0 on the
    CPU)."""

    def __init__(self):
        super().__init__(lambda: [0.0, 0, 0, 0])
        self.peak = 0
        self.slices: collections.Counter = collections.Counter()
        self.nslices: collections.Counter = collections.Counter()
        self.instances: collections.Counter = collections.Counter()
        self.helper: collections.Counter = collections.Counter()


@contextlib.contextmanager
def phase_timers(device: torch.device, phases=PHASES):
    """Yields a `Timings`, filled by the calls made inside the block to the
    functions of `phases` (PHASES + BATCH_PHASES for prove_batch,
    PARALLEL_PHASES for the collectives of a call with a mesh), and the
    batched MSMs' slicings made inside the block. A phase's peak is the most device memory
    allocated at any time inside its calls (0 on the CPU): each call
    resets the allocator's peak on entry, after handing the peak so far to
    the calls it is nested in."""
    acc = Timings()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in phases]
    counters = [(acc.slices, pippenger.slicings), (acc.nslices, pippenger.n_slicings),
                (acc.instances, signature.slicings), (acc.helper, protocol.helper_slicings)]
    before = [collections.Counter(c) for _, c in counters]
    cuda = device.type == "cuda"
    open_peaks: list = []  # peaks of the timed calls in progress, innermost last

    def lift(peak):
        open_peaks[:] = [max(p, peak) for p in open_peaks]

    def timer(fn, label):
        def timed(*args, **kwargs):
            _sync(device)
            if cuda:
                now = torch.cuda.max_memory_allocated(device)
                acc.peak = max(acc.peak, now)
                lift(now)
                torch.cuda.reset_peak_memory_stats(device)
            open_peaks.append(0)
            launches, t0 = mont_mul.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            row = acc[label]
            row[0] += time.perf_counter() - t0
            row[1] += 1
            row[2] += mont_mul.launches - launches
            peak = open_peaks.pop()
            if cuda:
                peak = max(peak, torch.cuda.max_memory_allocated(device))
                lift(peak)
                acc.peak = max(acc.peak, peak)
            row[3] = max(row[3], peak)
            return out

        return timed

    try:
        for (mod, name, fn), (_, _, label) in zip(saved, phases):
            setattr(mod, name, timer(fn, label))
        yield acc
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        if cuda:
            acc.peak = max(acc.peak, torch.cuda.max_memory_allocated(device))
        for (mine, counter), was in zip(counters, before):
            mine.update(counter - was)


def phase_table(acc: Timings) -> list:
    """The rows of `phase_timers`' table, phases first, longest first, then
    the slice counts of the batched MSMs, the MSMs cut along N and the
    helpers."""
    lines = [f"  {'phase':40s} {'s':>10s} {'calls':>6s} {'mont_mul launches':>18s} {'peak GiB':>9s}"]
    for label in sorted(acc, key=lambda k: (k.startswith("in "), -acc[k][0])):
        s, calls, launches, peak = acc[label]
        lines.append(f"  {label:40s} {s:10.4f} {calls:6d} {launches:18d} {peak / 2**30:9.2f}")
    for (M, N, k), calls in sorted(acc.slices.items()):
        lines.append(f"  batched MSM M={M} over N={N}: {k} slice(s) of M, {calls} call(s)")
    for (M, N, k), calls in sorted(acc.nslices.items()):
        lines.append(f"  MSM M={M} over N={N}: {k} slice(s) of N, {calls} call(s)")
    for (m, n, k), calls in sorted(acc.instances.items()):
        lines.append(f"  helper of m={m} at n={n}: {k} slice(s) of its instances, {calls} call(s)")
    for (B, k), calls in sorted(acc.helper.items()):
        lines.append(f"  prove_batch of {B}: the helper in {k} slice(s) of the proofs, {calls} call(s)")
    return lines


def device_profile(fn, device: torch.device, top: int = 20):
    """Run fn once under torch.profiler. Returns (wall s, device events,
    device busy s, [(kernel name, calls, ms)] busiest first)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by: dict = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by[e.name][0] += 1
        by[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(ms for _, ms in by.values()) / 1e3
    rows = sorted(((k, c, ms) for k, (c, ms) in by.items()), key=lambda r: -r[2])
    return wall, len(events), busy, rows[:top]


def _u64_words(limbs16: torch.Tensor, words: int) -> np.ndarray:
    """(N, 4 words) standard-form 16-bit limbs -> (N, words) little-endian
    uint64 words, on the host."""
    a = limbs16.cpu().numpy().astype(np.uint64).reshape(-1, words, 4)
    return np.ascontiguousarray(a[..., 0] | (a[..., 1] << 16) | (a[..., 2] << 32) | (a[..., 3] << 48))


def native_msm(points: Affine, scalars_std: torch.Tensor, parts: int | None = None):
    """sum_i s_i P_i by the native host Pippenger (`native/pairing.cpp`'s
    `sonic_g1_msm`, which `native.g1_msm_native` calls) over G1 rows on
    any device and standard-form Fr scalars (N, 16). The rows go to the
    host as arrays, not Python ints, and the points are cut into `parts`
    contiguous pieces (one a CPU core) that run on threads (ctypes lets
    go of the interpreter lock during the call); the pieces' sums are
    added by golden.g1_add. Returns a host affine tuple, None for
    infinity."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native_msm: the native pairing library did not build or load")
    pts = np.ascontiguousarray(np.concatenate(
        [_u64_words(limb.from_mont(points.x, FQ), 6), _u64_words(limb.from_mont(points.y, FQ), 6)], 1))
    inf = np.ascontiguousarray(points.inf.cpu().numpy().astype(np.uint8))
    sc = _u64_words(scalars_std, 4)
    n = inf.shape[0]
    k = max(1, min(parts or os.cpu_count() or 1, n))
    u64p, u8p = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_ubyte)

    def piece(lo: int, hi: int):
        out, out_inf = np.zeros(12, np.uint64), np.zeros(1, np.uint8)
        lib.sonic_g1_msm(pts[lo:hi].ctypes.data_as(u64p), inf[lo:hi].ctypes.data_as(u8p),
                         sc[lo:hi].ctypes.data_as(u64p), hi - lo, out.ctypes.data_as(u64p),
                         out_inf.ctypes.data_as(u8p))
        if out_inf[0]:
            return None
        return tuple(sum(int(w) << (64 * i) for i, w in enumerate(out[j : j + 6])) for j in (0, 6))

    bounds = [(n * i // k, n * (i + 1) // k) for i in range(k)]
    with concurrent.futures.ThreadPoolExecutor(k) as pool:
        sums = list(pool.map(lambda b: piece(*b), [b for b in bounds if b[1] > b[0]]))
    acc = None
    for p in sums:
        acc = golden.g1_add(acc, p)
    return acc


def _native_commit(srs: SRS, maxm: int, poly: laurent.Laurent):
    """commit_poly(srs, maxm, poly)'s point by `native_msm` over the same
    g_ax rows."""
    lo = poly.offset + srs.d - maxm + srs.d
    rows = slice(lo, lo + poly.length)
    return native_msm(Affine(srs.g_ax.x[rows], srs.g_ax.y[rows], srs.g_ax.inf[rows]),
                      limb.from_mont(poly.coeffs, FR))


def _srs_rows_checked(srs: SRS, x: int, alpha: int, rng: random.Random) -> list:
    """Rows of the G1 tables against golden.g1_mul: random ones, e = -d, 0
    and d, and both sides of every chunk boundary of the tables' one
    fixed-base batch (2 tables x (2d+1) rows, `fixed_base.chunk_rows`).
    Returns the rows checked; raises on a mismatch."""
    d, rows = srs.d, 2 * srs.d + 1
    step = fixed_base.chunk_rows(g1)
    edges = {i % rows for b in range(step, 2 * rows, step) for i in (b - 1, b)}
    idx = sorted(set(rng.sample(range(rows), min(SRS_ROWS_CHECKED, rows))) | {0, d, rows - 1} | edges)
    it = torch.tensor(idx, device=srs.g_x.x.device)
    for name in ("g_x", "g_ax"):
        tab = getattr(srs, name)
        got = g1.to_host(Affine(tab.x[it], tab.y[it], tab.inf[it]))
        want = []
        for i in idx:
            e = pow(x, i - d, gp.P)
            if name == "g_ax":
                e = 0 if i == d else alpha * e % gp.P
            want.append(golden.g1_mul(golden.G1_GEN, e))
        if got != want:
            raise AssertionError(f"breakdown --check: SRS {name} rows differ from golden.g1_mul")
    return idx


def _check_proof(srs, dc, da, rnd, proof, oracle, n, x, alpha, rng, say) -> None:
    """--check after the proves: verify True and False once tampered,
    pr_r and pr_t against native host MSMs, SRS rows against golden."""
    t0 = time.perf_counter()
    ok = protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
    t_verify = time.perf_counter() - t0
    bad = dataclasses.replace(proof, pr_a=(proof.pr_a + 1) % gp.P)
    if not ok or protocol.verify(srs, dc, bad, oracle.y, oracle.z, oracle.yzs):
        raise AssertionError(f"breakdown --check: verify {ok}, or a tampered proof verified")
    say(f"check: verify True in {t_verify} s, tampered False", flush=True)
    t0 = time.perf_counter()
    dev = da.aL.device
    y_m = FR.from_int(rnd.y, device=dev)
    r1 = r_x1_poly(da, FR.from_int(rnd.cns, device=dev))
    t_y = laurent.mul(r1, laurent.add(r_at_y(r1, y_m), s_at_y(dc, y_m)))
    tc = t_y.coeffs.clone()
    tc[-t_y.offset] = limb.sub(tc[-t_y.offset], k_at_y(dc, n, y_m), FR)
    t_y = laurent.Laurent(t_y.offset, tc)
    del tc
    if _native_commit(srs, n, r1) != proof.pr_r:
        raise AssertionError("breakdown --check: pr_r differs from the native host MSM")
    if _native_commit(srs, srs.d, t_y) != proof.pr_t:
        raise AssertionError("breakdown --check: pr_t differs from the native host MSM")
    say(f"check: pr_r ({r1.length} points) and pr_t ({t_y.length} points) equal to native host MSMs "
        f"over the same SRS rows ({time.perf_counter() - t0} s)", flush=True)
    del r1, t_y
    t0 = time.perf_counter()
    idx = _srs_rows_checked(srs, x, alpha, rng)
    say(f"check: {len(idx)} rows of g_x and of g_ax (random ones, e = -d, 0, d, both sides of every "
        f"fixed-base chunk boundary) equal to golden.g1_mul ({time.perf_counter() - t0} s)", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    # --gates: torchrun (torch 2.11) rejects --n as an ambiguous abbreviation of its own options
    parser.add_argument("--n", "--gates", type=int, default=1024, help="gates of the random circuit")
    parser.add_argument("--q", type=int, default=64, help="its linear constraints")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--reps", type=int, default=3, help="timed proves")
    parser.add_argument("--batch", type=int, default=0, help="prove_batch of this many circuits")
    parser.add_argument("--profiler", action="store_true", help="one more prove under torch.profiler")
    parser.add_argument("--check", action="store_true",
                        help="hold one process's proves to the checks above (not with --batch)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("breakdown: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.check and args.batch:
        parser.error("--check holds single proves; leave out --batch")
    t_start = time.perf_counter()
    rng = random.Random(args.seed)
    pairs = [random_circuit(rng, n=args.n, q=args.q) for _ in range(max(1, args.batch))]
    d = 7 * args.n + 20
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    t_gen = time.perf_counter() - t_start
    with distributed.launched_mesh() as mesh:
        if args.check and mesh is not None:
            raise RuntimeError("breakdown: --check runs in one process")
        # with a mesh, every rank runs everything and rank 0 reports
        say = print if mesh is None or mesh.get_local_rank() == 0 else (lambda *a, **k: None)
        _sync(device)
        t0 = time.perf_counter()
        srs = SRS.new(d, x, alpha, h_mode="verifier", n_hints=[args.n], device=device, mesh=mesh)
        _sync(device)
        t_srs, t0 = time.perf_counter() - t0, time.perf_counter()
        dcs = [DeviceCircuit.from_host(c, device=device) for c, _ in pairs]
        das = [DeviceAssignment.from_host(a, device=device) for _, a in pairs]
        _sync(device)
        t_up = time.perf_counter() - t0
        rnds = [gp.Randomness.generate(rng, m=args.q) for _ in pairs]
        phases = PHASES + (BATCH_PHASES if args.batch else [])
        say(f"set-up: random_circuit x{len(pairs)} {t_gen} s on the host, SRS.new (verifier mode) d={d} "
            f"{t_srs} s, circuit upload {t_up} s", flush=True)

        def prove():
            if args.batch:
                return protocol.prove_batch(srs, das, dcs, rnds, mesh=mesh)
            return protocol.prove(srs, das[0], dcs[0], rnds[0], mesh=mesh)

        outs = [prove()]  # warm-up
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(args.reps):
            outs = outs[:1]  # the last timed result goes before the next prove
            _sync(device)
            t0 = time.perf_counter()
            outs.append(prove())
            _sync(device)
            times.append(time.perf_counter() - t0)
        ranks = f", {mesh.size()} ranks" if mesh is not None else ""
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
        peak = f", peak device memory {peak_gib:.2f} GiB" if peak_gib is not None else ""
        what = f"prove_batch of {args.batch}" if args.batch else "prove"
        say(f"n={args.n} q={args.q} d={d} on {device}{ranks}: {what} s {times} "
            f"median {statistics.median(times) if times else None}{peak}", flush=True)

        with phase_timers(device, phases + (PARALLEL_PHASES if mesh is not None else [])) as acc:
            _sync(device)
            t0 = time.perf_counter()
            outs.append(prove())
            _sync(device)
            wall = time.perf_counter() - t0
        say(f"{what} with phase timers: {wall} s", flush=True)
        say("\n".join(phase_table(acc)), flush=True)

        if args.check:
            digests = {hashlib.sha256(serial.proof_to_bytes(p)).hexdigest() for p, _ in outs}
            if len(digests) != 1:
                raise AssertionError(f"breakdown --check: {len(outs)} proves gave {len(digests)} proofs")
            say(f"check: {len(outs)} proves, one proof, sha256 {digests.pop()}", flush=True)
            if peak_gib is not None and peak_gib > HUGE_PEAK_GIB:
                raise AssertionError(f"breakdown --check: peak device memory {peak_gib:.2f} GiB exceeds "
                                     f"{HUGE_PEAK_GIB} GiB")
            proof, oracle = outs[-1]
            _check_proof(srs, dcs[0], das[0], rnds[0], proof, oracle, args.n, x, alpha, rng, say)
            say(f"check: passed; {time.perf_counter() - t_start} s for the run", flush=True)

        if args.profiler:
            pwall, nev, busy, rows = device_profile(prove, device)
            share = 100 * busy / pwall
            say(f"prove under torch.profiler: wall {pwall} s; device events {nev}, "
                f"busy {busy} s ({share:.1f} % of wall)", flush=True)
            for name, calls, ms in rows:
                say(f"  {ms:10.3f} ms {calls:7d}x  {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
