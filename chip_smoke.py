#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sonic_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels (csrc/ -> sonic_tpu_torch/_build/) and the native
pairing library (native/pairing.cpp), then runs, each phase timed after
torch.cuda.synchronize():

  1. card     the device name, `nvidia-smi` name and power limit, the SM
              clock limit, and the bucket kernel's resident threads;
  2. kernel 1 Montgomery multiply, Fr and Fq, 2^20 random canonical
              elements plus 0, 1 and N-1: equal to mont_mul_plain; timed
              beside its byte bound;
  3. kernel 2 bucket sums (lane-free, sorted by bucket) on random digits
              with infinities, zeros and negative digits at M=2 (also
              against bucket_sums_plain on CPU copies, plain torch
              throughout), and on the 2^16-point MSM's own plan, timed:
              the whole (M, W, B) output equal to bucket_sums_plain; then
              a full 2^16-point MSM equal to the native host Pippenger,
              and a G2 MSM (pippenger.msm_g2: the same plan, summed by
              bucket_sums_plain over G2, whose Fq2 products are kernel 1's)
              equal to golden G2 multiples summed on the host;
  4. vectors  example1/example2 of tests/vectors/pinned_v1.json: the proof
              bytes equal `proof_hex`, verify True, False after tampering;
  5. main path random_circuit(Random(42), n=1024, q=64), d = 7n+20: SRS.new
              on the card, one warm-up and three timed proofs, verify True
              and False after tampering, pr_r / pr_t equal to native host
              MSMs over the SRS rows, both kernels' launch counts, and the
              phase table of one prove (sonic_tpu_torch.breakdown). Every
              kernel-2 launch of the counted prove (the helper's batched
              ones at M=64 included; the first of them timed) is kept and
              then held, output for output, against bucket_sums_plain on
              the same inputs; kernel 1 is timed at its most-launched
              shape, on random operands of that shape; kernel 3 (the
              MSM tail) on the inputs of one more prove's window combine
              (R = 4m + 7 = 263 MSMs) and of its largest weighted sum (the
              helper's M = 64 MSMs), each equal to its plain twin (the
              combine in projective form, the weighted sum affine) and
              timed beside the plain twin and beside one row alone (the
              serial chain that bounds it);
  6. full SRS SRS.new(h_mode="full") at d = 2^16 (all four tables on the
              card, G2 over Fq2, fixed-base window tables), timed, with
              each group's window table and fixed_base_mul timed: 64
              random rows of each table equal to golden.g1_mul/g2_mul on
              the host, 4,096 rows of each G1 table equal to the same
              scalars through the double-and-add ladder, a save_srs /
              load_srs round trip, and the pinned `srs_sha256` of
              example1/example2 from SRS.new on the card; kernel 1's
              launches;
  7. batch    prove_batch of B=64 random_circuit(n=1024, q=8) on phase 5's
              SRS: one warm-up and three timed calls, the phase table of
              one more (sonic_tpu_torch.breakdown), all 64 proofs verify
              True and a tampered one False, proofs 0 and 63 byte-equal to
              protocol.prove; both kernels' launch counts; its kernel-2
              launches against bucket_sums_plain (the largest and the first
              of each (M, W, B) shape always, the rest while a 120 s
              budget lasts; the output says which);
  8. Fiat-Shamir  on example2's host SRS, fiat_shamir.prove_device byte-equal
              to the host fiat_shamir.prove, verify True; on phase 5's
              circuit, prove_device timed, equal to protocol.prove with the
              Randomness of its own derived challenges, verify True;
              its kernel-2 launches against bucket_sums_plain;
  9. multi-rank  WORLD = 2 ranks (torch.multiprocessing, spawn, a file://
              store), NCCL with a card per rank, else gloo with both ranks
              on cuda:0 (NCCL refuses two ranks on one GPU). Each rank runs
              SRS.new(mesh) at d = 7n+20 (verifier mode; its G1 tables'
              digest equal to phase 5's SRS), prove(mesh) on phase 5's
              circuit and randomness, one warm-up and one timed, both
              byte-equal to phase 5's proof, verify True, the t product
              through the sharded four-step NTT (N = 8192 = 64 x 128),
              prove_batch(mesh) on phase 7's circuits, byte-equal to phase
              7's proofs, and SRS.new(mesh) at d = 2^16 (full; all four
              tables' digest equal to phase 6's); seconds in the
              collectives (sync timers, breakdown.PARALLEL_PHASES) of the
              timed prove and of each SRS.new. Each rank counts its
              launches inside its own Path and fails if a kernel was never
              launched; rank 0 holds its first kernel-2 launch against
              bucket_sums_plain. Two ranks on one card measure that the
              path runs and is right, not scaling;
 10. big      BASELINE config 3 (bench.py's _bench_big_roundtrip), run
              last, after this process has dropped the earlier phases'
              tensors and emptied its allocator cache:
              random_circuit(Random(77), n=2^16, q=64), x and alpha from the
              same rng, d = 7n+20 = 458,772. The circuit upload, SRS.new in
              verifier mode on the card and a save_srs / load_srs round trip
              (the loaded G1 tables' digest equal to the generated ones'),
              each timed; one warm-up prove and verify on the loaded SRS
              inside the path (the first kernel-2 launch of each (M, W, B,
              N) kept), verify True; the kept kernel-2 launches against
              bucket_sums_plain (the smallest and a helper slice always,
              the rest while BIG_PLAIN_BUDGET_S lasts, and every other one
              on its last MSM row: against bucket_sums_plain on a plan of
              that row alone, in affine form), then let go; one
              timed prove whose peak device memory must stay within
              BIG_PEAK_GIB, and the phase table of one more (peak memory
              per phase, slices of each batched MSM); pr_r, pr_t and
              helper commitments 0 and 63 equal to native host MSMs over
              the same SRS rows; a tampered proof False;
 11. big batch BASELINE config 5 at its own size (bench.py's
              _bench_prove_batch): B=64 random_circuit(Random(88), n=2^16,
              q=8) on phase 10's SRS, their generation and upload timed
              apart; one prove_batch (the helper streamed over slices of
              the proofs), its seconds, proofs/s, peak device memory
              (within BIG_PEAK_GIB) and helper slices; the first kernel-2
              launch of each (M, W, B, N) timed as it ran and held against
              bucket_sums_plain as it ran (the first always, the rest
              while BIG_BATCH_PLAIN_BUDGET_S lasts, every other one on its
              last MSM row as in phase 10); proof 32 byte-equal
              to protocol.prove, all 64 verify True, a tampered one False;
 12. big SRS  SRS.new(h_mode="full") at phase 10's d = 458,772 (bench.py's
              _bench_srs at the big degree): its seconds, peak device
              memory and fixed-base chunks; rows of all four tables
              (random ones, e = -d, 0, d, both sides of every chunk
              boundary) equal to golden.g1_mul/g2_mul on the host; a
              save_srs / load_srs round trip, timed, all tables equal;
 13. huge MSMs BASELINE config 4's MSMs (an n = 2^20 circuit): 2^20 G1
              points by fixed_base_mul; the 2^20-point MSM timed whole and
              under sync timers (digits, plan, scan, tail); MSMs over
              t's commitment's N = 7n + 8 = 7,340,040 and the helper's
              3n + 1 = 3,145,729 points (the 2^20 points tiled), cut along
              N within the step budget (`pippenger.n_slicings`, 3 and 2
              slices), each equal, affine, to the uncut 2^20-point MSM of
              the scalars summed mod r on each point; the first kernel-2
              launch of each kind of slice timed and held against
              bucket_sums_plain; the peak device memory.
 14. division kernel 4 (the openings' division, poly/div.py) at the main
              path's division shapes: M = 64 x D = 196,609 (the helper's
              W_j at n = 2^16, m = 64), 16 x 255,009 (the MiMC circuit's
              Q_j over s(u, Y)), 1 x 458,757 (t's opening) and 16 x 196,613;
              f(z) and the quotients equal to the plain version (in the
              division's budget slices, kernel 1 and plain torch), each
              call timed by CUDA events beside its byte bound (128 B read
              a coefficient, 128 B written a quotient coefficient) and the
              plain version's time and kernel-1 launches.

Bounds: kernel 1's from the bytes it must move (each input read once, the
output written once) over 3.35 TB/s; kernel 2's from its plan's mixed
additions (nonzero digits on finite points), 11 Fq products of 2 * 12^2
word products each, a word product being two 32-bit multiply-adds (lo and
hi), over 64 multiply-adds a clock per SM at the SM clock limit.

Every path (phase 3's G2 MSM, phases 5-13) runs with the launch counters
of kernels 1-4 set to 0 just before it and read just after, and fails if
a kernel it uses was never launched (every path that proves uses all
four, the huge MSMs the first three; the G2 MSM and the SRS builds
kernel 1 alone);
phase 9's launches are summed over its ranks. Inside
every path (on every rank) the first kernel-1 launch of each operand
shape is held against mont_mul_plain as it runs; the timers leave the
seconds of these checks out, and a path's peak memory their allocations.
Phase 11 holds kernel 2 against bucket_sums_plain inside its path; the
kernel-1 launches of those plain sums stay out of the path's count.
A kernel-2 plain time (plain_ms) is that of the one plain run that checks
the launch.
Every comparison is exact (all values are integers); a failed one raises.
The line before last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script fails before printing
any result.
"""
from __future__ import annotations

import collections
import hashlib
import json
import math
import os
import pickle
import random
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
IMAD_PER_CLOCK_PER_SM = 64  # 32-bit integer multiply-add, compute capability 9.0
FQ_WORDS = 12
IMAD_PER_MIXED_ADD = 11 * 2 * FQ_WORDS * FQ_WORDS * 2

DEVICE = "cuda"
K1_N = 1 << 20  # phase 2: products per field
MSM_N = 1 << 16  # phase 3: MSM points
MAIN_N, MAIN_Q, PROVE_RUNS = 1024, 64, 3  # phase 5 (and 7's n, 8's circuit)
SRS_D, SRS_ROWS_CHECKED, LADDER_ROWS = 1 << 16, 64, 4096  # phase 6
BATCH_B, BATCH_Q = 64, 8  # phase 7
PLAIN_BUDGET_S = 120.0  # phase 7: time for kernel 2 against bucket_sums_plain
G2_MSM_N = 64  # phase 3: G2 MSM points
WORLD, WORLD_TIMEOUT_S = 2, 600  # phase 9
BIG_N, BIG_Q = 1 << 16, 64  # phase 10
BIG_PEAK_GIB = 40.0  # phase 10: most device memory one prove may allocate
BIG_PLAIN_BUDGET_S = 60.0  # phase 10: time for kernel 2 against bucket_sums_plain
BIG_BATCH_B, BIG_BATCH_Q = 64, 8  # phase 11, at phase 10's n
BIG_BATCH_PLAIN_BUDGET_S = 45.0  # phase 11: time for kernel 2 against bucket_sums_plain
BIG_SRS_ROWS_CHECKED = 24  # phase 12: random rows a table against golden
HUGE_N = 1 << 20  # phase 13: BASELINE config 4's n
# phase 14: (M, D, offset) of the divisions timed, and timed calls of each
POLY_DIV_SHAPES = [(64, 196_609, -65_536), (16, 255_009, -189_472), (1, 458_757, -262_148),
                   (16, 196_613, -131_076)]
POLY_DIV_REPS = 5
ROW_PROBE = 1 << 18  # phase 12: rows of the fixed_base_mul whose bytes a row are measured


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def srs_digest(srs) -> str:
    """tests/test_vectors.py's SRS digest of a host (golden) SRS."""
    from sonic_tpu_torch import serial

    h = hashlib.sha256()
    for tab in (srs.g_neg_x, srs.g_pos_x, srs.g_neg_ax, srs.g_pos_ax):
        for p in tab:
            h.update(serial.g1_to_bytes(p))
    for tab in (srs.h_neg_x, srs.h_pos_x, srs.h_neg_ax, srs.h_pos_ax):
        for p in tab:
            h.update(serial.g2_to_bytes(p))
    return h.hexdigest()


def row_err(pts, plan, out, src) -> int:
    """Kernel 2's bucket sums `out` of `plan`, on its last MSM row, against
    bucket_sums_plain on a plan of that row alone (its digits in `src`,
    kept by `Path`), in affine form: the one-row plan cuts its chunks
    elsewhere, so the projective sums may differ. Raises on a mismatch;
    returns the max abs error of the affine coordinates (0)."""
    import torch

    from sonic_tpu_torch.curve.group import g1
    from sonic_tpu_torch.msm import bucket_acc

    digits, nb = src
    rplan = bucket_acc.make_plan(pts.inf, digits.to(pts.inf.device, torch.int64), nb)
    want = g1.to_affine(bucket_acc.bucket_sums_plain(pts, rplan).map(lambda a: a[0]))
    got = g1.to_affine(out.map(lambda a: a[-1]))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel 2 {plan.shape} over N={plan.npoints}: its last MSM row differs "
                             f"from bucket_sums_plain on that row's own plan")
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def plain_err(out, a, b, spec, limit: int = 1 << 20) -> int:
    """max |out - mont_mul_plain(a, b)|, the plain version (elementwise)
    taken over slices of at most `limit` elements of the broadcast shape."""
    from sonic_tpu_torch.fields import mont_mul

    a, b = a.expand(out.shape), b.expand(out.shape)
    rows = out[..., 0].numel()
    if rows <= limit:
        return int((out - mont_mul.mont_mul_plain(a, b, spec)).abs().max()) if rows else 0
    if out.shape[0] == 1:
        return plain_err(out[0], a[0], b[0], spec, limit)
    per = max(1, out.shape[0] * limit // rows)
    return max(plain_err(out[i:i + per], a[i:i + per], b[i:i + per], spec, limit)
               for i in range(0, out.shape[0], per))


class Path:
    """Drives one path of the port: the launch counters of kernels 1-4
    are set to 0 on entry and read on exit. The first kernel-1
    launch of each operand shape is held against mont_mul_plain as it
    happens (`plain_err`; the errors go to `k1_err`), and kernel-1
    launches are counted by shape. It keeps the inputs of every kernel-2 launch (of the first
    `keep_sums`, when given; with `sums_by_shape`, of the first launch of
    each plan shape (M, W, B) and point count N), so that kernel 2 can be
    held against its plain version afterwards. With `check_sums_s`, it
    keeps nothing and instead holds the first launch of each (M, W, B, N)
    against bucket_sums_plain as it happens: the path's first launch
    always, a later one while its estimated plain time (its entries at the
    slowest rate seen so far) fits in what is left of `check_sums_s`
    seconds, and any other on its last MSM row alone (`row_err`); every
    first launch is timed with CUDA events as it runs (`k2_new`). With
    `sums_by_shape` or `check_sums_s`, the digits of the last MSM row of
    the first plan of each (M, W, B, N) are kept on the host (`row_src`).
    The checks' seconds add up in `Path.check_s`, which the script's
    timers leave out, and `peak` is the path's peak device memory without
    the checks' allocations."""

    check_s = 0.0

    def __init__(self, name: str, uses=("mont_mul", "bucket_sums", "msm_tail", "poly_div"),
                 keep_sums: int | None = None,
                 sums_by_shape: bool = False, check_sums_s: float | None = None):
        self.name, self.uses, self.keep_sums, self.sums_by_shape = name, uses, keep_sums, sums_by_shape
        self.check_sums_s = check_sums_s
        self.sums, self.sum_shapes, self.shape_count, self.k1_err = [], set(), {}, []
        self.k2_new, self.k2_err, self.peak, self.row_src = [], [], 0, {}

    def _checking(self):
        """Enter a check: the path's peak so far is kept, and the check's
        own allocations will not count (see `_checked`)."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        return time.perf_counter()

    def _checked(self, t0: float) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        Path.check_s += time.perf_counter() - t0
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()

    def _check_sums(self, pts, plan, out, events) -> None:
        """Hold a launch against bucket_sums_plain inline (see the class)."""
        import torch

        from sonic_tpu_torch.msm import bucket_acc

        t0 = self._checking()
        rate = max((s_ / e_ for e_, s_ in self._rates), default=0.0)
        ms = events[0].elapsed_time(events[1]) if events else None
        row = {"shape": list(plan.shape), "npoints": plan.npoints, "entries": plan.entries, "ms": ms,
               "plain_ms": None, "row_plain_ms": None}
        if not self.k2_new or rate * plan.entries <= self.check_sums_s - self._sums_wait:
            want = self._plain(lambda: bucket_acc.bucket_sums_plain(pts, plan))
            if not all(torch.equal(g, w) for g, w in zip(out, want)):
                raise AssertionError(f"{self.name}: kernel 2 {plan.shape} over N={plan.npoints} differs "
                                     f"from bucket_sums_plain")
            self.k2_err.append(max(int((g - w).abs().max()) for g, w in zip(out, want)))
            took = time.perf_counter() - t0
            row["plain_ms"] = 1e3 * took
            self._rates.append((max(plan.entries, 1), took))
            self._sums_wait += took
        else:
            key = (plan.shape, plan.npoints)
            self.k2_err.append(self._plain(lambda: row_err(pts, plan, out, self.row_src[key])))
            row["row_plain_ms"] = 1e3 * (time.perf_counter() - t0)
        self.k2_new.append(row)
        self._checked(t0)

    def _plain(self, fn):
        """fn(): the plain sums' Fq products are kernel-1 launches on the
        card; they bypass the path's kernel-1 checks and leave its count as
        it was."""
        from sonic_tpu_torch.fields import mont_mul

        counted, checking = mont_mul.launches, mont_mul.mont_mul
        mont_mul.mont_mul = self._real[1]
        try:
            return fn()
        finally:
            mont_mul.mont_mul, mont_mul.launches = checking, counted

    def __enter__(self):
        import torch

        from sonic_tpu_torch.fields import mont_mul
        from sonic_tpu_torch.msm import bucket_acc, pippenger, tail
        from sonic_tpu_torch.poly import div

        self._real = real_sums, real_mul, real_plan = pippenger.bucket_sums, mont_mul.mont_mul, pippenger.make_plan
        self._sums_wait, self._rates = 0.0, []

        def plan_keep(inf, digits, nbuckets, chunks=None):
            plan = real_plan(inf, digits, nbuckets, chunks)
            key = (plan.shape, plan.npoints)
            if key not in self.row_src:
                t0 = self._checking()
                self.row_src[key] = (digits.reshape((-1,) + digits.shape[-2:])[-1].to("cpu", torch.int8), nbuckets)
                self._checked(t0)
            return plan

        def sums_keep(pts, plan):
            key = (plan.shape, plan.npoints)
            if self.check_sums_s is not None:
                if key in self.sum_shapes:
                    return real_sums(pts, plan)
                self.sum_shapes.add(key)
                events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if torch.cuda.is_available() else None
                if events:
                    events[0].record()
                out = real_sums(pts, plan)
                if events:
                    events[1].record()
                self._check_sums(pts, plan, out, events)
                return out
            if self.sums_by_shape:
                if key not in self.sum_shapes:
                    self.sum_shapes.add(key)
                    self.sums.append((pts, plan))
            elif self.keep_sums is None or len(self.sums) < self.keep_sums:
                self.sums.append((pts, plan))
            return real_sums(pts, plan)

        def mul_check(a, b, spec):
            key = (spec.name, tuple(a.shape), tuple(b.shape))
            self.shape_count[key] = self.shape_count.get(key, 0) + 1
            out = real_mul(a, b, spec)
            if self.shape_count[key] == 1:
                t0 = self._checking()
                err = plain_err(out, a, b, spec)
                self._checked(t0)
                self.k1_err.append(err)
                if err:
                    raise AssertionError(f"{self.name}: kernel 1 {spec.name} {tuple(a.shape)} x "
                                         f"{tuple(b.shape)} differs from mont_mul_plain")
            return out

        pippenger.bucket_sums, mont_mul.mont_mul = sums_keep, mul_check
        if self.sums_by_shape or self.check_sums_s is not None:
            pippenger.make_plan = plan_keep
        mont_mul.launches = bucket_acc.launches = tail.launches = div.launches = 0
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        import torch

        from sonic_tpu_torch.fields import mont_mul
        from sonic_tpu_torch.msm import bucket_acc, pippenger, tail
        from sonic_tpu_torch.poly import div

        self.launches = {"mont_mul": mont_mul.launches, "bucket_sums": bucket_acc.launches,
                         "msm_tail": tail.launches, "poly_div": div.launches}
        pippenger.bucket_sums, mont_mul.mont_mul, pippenger.make_plan = self._real
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        if exc[0] is None:
            never = [k for k in self.uses if self.launches[k] == 0]
            if never:
                raise AssertionError(f"{self.name}: kernel(s) {never} never launched: {self.launches}")
        return False


def multi_rank(rank: int, world: int, backend: str, tmp: str) -> None:
    """Phase 9, one rank: the sharded SRS, prove and prove_batch against
    the references in tmp/refs.pkl (written by this script's parent
    process); writes tmp/rank<r>.json."""
    import torch

    from sonic_tpu_torch import breakdown, protocol, serial
    from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
    from sonic_tpu_torch.msm import bucket_acc
    from sonic_tpu_torch.multichip import table_digest
    from sonic_tpu_torch.parallel import distributed, ntt_sharded
    from sonic_tpu_torch.srs import SRS

    os.environ["LOCAL_RANK"] = str(rank)
    distributed.initialize(backend=backend, init_method=f"file://{tmp}/store", world_size=world, rank=rank)
    mesh = distributed.global_mesh()
    dev = torch.device(DEVICE)  # the rank's card after initialize: LOCAL_RANK modulo the count
    with open(os.path.join(tmp, "refs.pkl"), "rb") as f:
        refs = pickle.load(f)
    n, q, d, x, alpha, circuit, assignment, rnd, proof_bytes, g1_digest = refs["main"]
    full_d, sx, salpha, full_digest = refs["full"]
    bpairs, brnds, bbytes = refs["batch"]
    dc = DeviceCircuit.from_host(circuit, device=dev)
    da = DeviceAssignment.from_host(assignment, device=dev)
    bdcs = [DeviceCircuit.from_host(c_, device=dev) for c_, _ in bpairs]
    bdas = [DeviceAssignment.from_host(a_, device=dev) for _, a_ in bpairs]
    out = {"rank": rank, "device": f"{DEVICE}:{torch.cuda.current_device()}"}

    def timed(key, fn, coll=None):
        torch.cuda.synchronize(dev)
        t0, c0 = time.perf_counter(), Path.check_s
        if coll is None:
            res = fn()
        else:
            with breakdown.phase_timers(dev, breakdown.PARALLEL_PHASES) as acc:
                res = fn()
            out[f"coll_{coll}"] = {k: v[:2] for k, v in acc.items()}
        torch.cuda.synchronize(dev)
        out[key] = time.perf_counter() - t0 - (Path.check_s - c0)
        return res

    sharded_ntts = []
    real_mul = ntt_sharded.poly_mul_ntt_sharded

    def counted(a, b, m):
        sharded_ntts.append(1)
        return real_mul(a, b, m)

    ntt_sharded.poly_mul_ntt_sharded = counted
    # the full SRS goes last: its kernel-1 inputs, kept by the Path, are the largest
    with Path("multi_rank", keep_sums=1) as path:
        srs = timed("t_srs_v", lambda: SRS.new(d, x, alpha, h_mode="verifier", n_hints=[n], device=dev,
                                               mesh=mesh), "srs_v")
        if table_digest(srs, ("g_x", "g_ax")) != g1_digest:
            raise AssertionError(f"phase 9 rank {rank}: SRS.new(mesh) verifier G1 tables differ from phase 5's")
        for key, coll in (("t_warm", None), ("t_prove", "prove")):
            proof, oracle = timed(key, lambda: protocol.prove(srs, da, dc, rnd, mesh=mesh), coll)
            if serial.proof_to_bytes(proof) != proof_bytes:
                raise AssertionError(f"phase 9 rank {rank}: prove(mesh) differs from phase 5's proof")
        out["sharded_ntts"] = len(sharded_ntts) // 2
        if not protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
            raise AssertionError(f"phase 9 rank {rank}: verify returned False")
        batch = timed("t_batch", lambda: protocol.prove_batch(srs, bdas, bdcs, brnds, mesh=mesh))
        if [serial.proof_to_bytes(p) for p, _ in batch] != bbytes:
            raise AssertionError(f"phase 9 rank {rank}: prove_batch(mesh) differs from phase 7's proofs")
        del batch
        full = timed("t_srs_full", lambda: SRS.new(full_d, sx, salpha, h_mode="full", device=dev,
                                                   mesh=mesh), "srs_full")
        if table_digest(full) != full_digest:
            raise AssertionError(f"phase 9 rank {rank}: SRS.new(mesh) full tables differ from phase 6's")
        del full
    out["launches"] = path.launches
    out["peak_gib"] = path.peak / 2**30
    out["k1_err"], out["k2_err"] = path.k1_err, []
    # rank 0's kernel-2 check below runs on memory the other ranks hand back first
    del srs, dc, da, bdcs, bdas, proof, oracle
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        pts, plan = path.sums.pop()
        got, want = bucket_acc.bucket_sums(pts, plan), bucket_acc.bucket_sums_plain(pts, plan)
        out["k2_err"].append(max(int((g - w).abs().max()) for g, w in zip(got, want)))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("phase 9 rank 0: kernel 2 differs from bucket_sums_plain")
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def poly_div_phase(dev, shapes=POLY_DIV_SHAPES, reps=POLY_DIV_REPS) -> dict:
    """Phase 14: kernel 4 at each (M, D, offset) of `shapes` on random
    canonical coefficients and nonzero points: one call (`div.divide`)
    against the plain version in the division's budget slices (timed
    once), then `reps` calls timed by CUDA events after a warm-up. Raises
    on any difference; returns {"M x D": row}."""
    import torch

    from sonic_tpu_torch import budget
    from sonic_tpu_torch.fields import mont_mul
    from sonic_tpu_torch.fields.limb import FR
    from sonic_tpu_torch.poly import div, laurent

    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for M, D, offset in shapes:
        coeffs = torch.randint(0, 1 << 16, (M, D, FR.nlimbs), generator=gen, device=dev)
        coeffs[..., -1] = torch.randint(0, FR.mod_limbs[-1], (M, D), generator=gen, device=dev)
        zs = torch.randint(0, 1 << 16, (M, FR.nlimbs), generator=gen, device=dev)
        zs[:, -1] = torch.randint(1, FR.mod_limbs[-1], (M,), generator=gen, device=dev)
        fz, w = div.divide(offset, coeffs, zs)
        per = budget.per_step(budget.COEFF_BYTES * D)
        k1 = mont_mul.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [laurent.div_by_linear_batched_plain(offset, coeffs[i : i + per], zs[i : i + per])
                for i in range(0, M, per)]
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        plain_k1 = mont_mul.launches - k1
        if not (torch.equal(fz, torch.cat([f for f, _ in outs])) and torch.equal(w, torch.cat([q for _, q in outs]))):
            raise AssertionError(f"phase 14: kernel 4 at M={M}, D={D} differs from the plain version")
        del outs, fz, w
        # timed as the prover calls it: each call's outputs freed before the next, so the
        # allocator hands the same blocks back (fresh device memory costs more to first touch)
        div.divide(offset, coeffs, zs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            div.divide(offset, coeffs, zs)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        bound_ms = 128 * (M * D + M * (D - 1)) / HBM_BYTES_PER_S * 1e3
        K = div.chunk_len(M, D, sms)
        rows[f"{M}x{D}"] = {"M": M, "D": D, "offset": offset, "K": K, "chunks": M * -(-D // K), "ms": ms,
                            "bound_ms": bound_ms, "share": bound_ms / ms, "plain_ms": plain_ms,
                            "plain_slices": -(-M // per), "plain_mont_mul_launches": plain_k1}
        log(f"phase 14 kernel 4 M={M} D={D} (K={K}, {M * -(-D // K)} chunks): {ms:.3f} ms a call, byte bound "
            f"{bound_ms:.3f} ms ({100 * bound_ms / ms:.1f} %); plain version {plain_ms:.1f} ms in "
            f"{-(-M // per)} slice(s), {plain_k1} kernel-1 launches; f(z) and quotients equal")
        del coeffs, zs
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from sonic_tpu_torch import breakdown, budget, fiat_shamir, golden, kernels, native, protocol, serial
    from sonic_tpu_torch import golden_protocol as gp
    from sonic_tpu_torch.circuit import example_circuit_1, example_circuit_2, random_circuit
    from sonic_tpu_torch.constraints import (
        DeviceAssignment, DeviceCircuit, k_at_y, r_at_y, r_x1_poly, s_at_y, s_at_y_batched,
    )
    from sonic_tpu_torch.curve.group import Affine, g1, g2
    from sonic_tpu_torch.fields import limb, mont_mul
    from sonic_tpu_torch.fields.limb import FQ, FR
    from sonic_tpu_torch import srs as srs_module
    from sonic_tpu_torch.msm import bucket_acc, fixed_base, pippenger, tail
    from sonic_tpu_torch.multichip import table_digest
    from sonic_tpu_torch.poly import laurent
    from sonic_tpu_torch.srs import SRS

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev)
    gen.manual_seed(20240601)
    paths = {}  # path name -> its kernel launches

    def timed(fn):
        sync()
        t0, c0 = time.perf_counter(), Path.check_s
        out = fn()
        sync()
        return out, time.perf_counter() - t0 - (Path.check_s - c0)

    def event_ms(fn, reps):
        fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    def rand_canonical(spec, n):
        """n random canonical limb vectors (top limb below the modulus's)."""
        x = torch.randint(0, 1 << 16, (n, spec.nlimbs), generator=gen, device=dev)
        x[:, -1] = torch.randint(0, spec.mod_limbs[-1], (n,), generator=gen, device=dev)
        return x

    # -- set-up: builds ----------------------------------------------------------
    _, t_build = timed(kernels.build)
    log(f"setup: CUDA kernels built in {t_build:.1f} s ({kernels.build()})")
    for line in kernels.build_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("native pairing library did not build or load")
    log(f"setup: native pairing library built and loaded in {time.perf_counter() - t0:.1f} s")

    # -- phase 1: card ---------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fill = kernels.lib().sonic_bucket_sums_fill(0)
    imad_per_ms = IMAD_PER_CLOCK_PER_SM * sms * sm_mhz * 1e3
    log(f"phase 1 card: torch sees {name!r}, {torch.cuda.device_count()} device(s); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; {sms} SMs, SM clock limit "
        f"{sm_mhz:.0f} MHz; bucket scan kernel: {fill} resident threads "
        f"({fill / sms / 32:.1f} warps per SM)")
    log(card)

    def k1_bound_ms(a, b, nout):
        return (a.numel() + b.numel() + nout) * 8 / HBM_BYTES_PER_S * 1e3

    def k2_bound_ms(plan):
        return plan.entries * IMAD_PER_MIXED_ADD / imad_per_ms

    # -- phase 2: kernel 1 ---------------------------------------------------------------
    k1 = {}
    for spec in (FR, FQ):
        n = K1_N
        edge = torch.tensor([[0] * spec.nlimbs, [1] + [0] * (spec.nlimbs - 1), list(spec.mod_limbs)],
                            dtype=torch.int64, device=dev)
        edge[2, 0] -= 1  # N - 1 (the modulus is odd)
        a = torch.cat([rand_canonical(spec, n), edge])
        b = torch.cat([rand_canonical(spec, n), edge.flip(0)])
        got = mont_mul.mont_mul(a, b, spec)
        want = mont_mul.mont_mul_plain(a, b, spec)
        sync()
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel 1 {spec.name}: {int((got != want).any(-1).sum())} elements differ")
        ms = event_ms(lambda: mont_mul.mont_mul(a, b, spec), 20)
        plain_ms = event_ms(lambda: mont_mul.mont_mul_plain(a, b, spec), 3)
        bound = k1_bound_ms(a, b, got.numel())
        k1[spec.name] = (err, ms, plain_ms, bound)
        log(f"phase 2 kernel 1 {spec.name}: {n + 3} products equal to mont_mul_plain "
            f"(max abs err {err}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"byte bound {bound:.4f} ms ({100 * bound / ms:.1f} % of it)")

    # -- phase 3: kernel 2 ---------------------------------------------------------------
    N = MSM_N
    base = g1.from_affine(g1.generator(dev))
    (aff, t_pts) = timed(lambda: g1.to_affine(g1.scalar_mul(base, rand_canonical(FR, N))))
    inf = torch.zeros(N, dtype=torch.bool, device=dev)
    inf[::37] = True
    points = Affine(aff.x, aff.y, inf)
    log(f"phase 3 kernel 2: {N} G1 points made on the card in {t_pts:.1f} s")

    def check_sums(pts, plan, label, time_it=True):
        got = bucket_acc.bucket_sums(pts, plan)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = bucket_acc.bucket_sums_plain(pts, plan)
        end.record()
        sync()
        plain_ms = start.elapsed_time(end)
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"kernel 2 {label}: bucket sums differ from bucket_sums_plain")
        what = (f"E={plan.entries} chunks={plan.chunks} steps={plan.steps} "
                f"partials={plan.npartials}; sums {tuple(got.x.shape)} equal to bucket_sums_plain "
                f"(max abs err {err})")
        if not time_it:
            log(f"  kernel 2 {label}: {what}")
            return err, None, None, None
        ms = event_ms(lambda: bucket_acc.bucket_sums(pts, plan), 5)
        bound = k2_bound_ms(plan)
        log(f"  kernel 2 {label}: {what}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"multiply-add bound {bound:.3f} ms ({100 * bound / ms:.1f} % of it)")
        return err, ms, plain_ms, bound

    M, Nr, c = 2, min(1024, N), 8
    W, nb = 256 // c + 1, (1 << (c - 1)) + 1
    small = Affine(points.x[:Nr], points.y[:Nr], points.inf[:Nr])
    digits = torch.randint(-(nb - 1), nb, (M, Nr, W), generator=gen, device=dev)
    digits[:, ::5] = 0
    plan = bucket_acc.make_plan(small.inf, digits, nb)
    k2_err = [check_sums(small, plan, f"random digits M={M} N={Nr} c={c}")[0]]
    # on the CPU, bucket_sums_plain's products are mont_mul_plain's, so this
    # oracle involves no kernel at all
    cpu = bucket_acc.bucket_sums_plain(Affine(*(a.cpu() for a in small)), plan.to("cpu"))
    got = bucket_acc.bucket_sums(small, plan)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, cpu)):
        raise AssertionError("kernel 2: bucket sums differ from bucket_sums_plain on the CPU")
    log(f"  kernel 2 random digits M={M} N={Nr} c={c}: equal to bucket_sums_plain on CPU copies")

    scalars = rand_canonical(FR, N)
    msm_digits, c_msm, nb_msm = pippenger._lay_out(scalars, None)
    t_plan = event_ms(lambda: bucket_acc.make_plan(points.inf, msm_digits, nb_msm), 3)
    plan16 = bucket_acc.make_plan(points.inf, msm_digits, nb_msm)
    log(f"  kernel 2 2^16-point MSM plan (c={c_msm}): {t_plan:.3f} ms")
    err, k2_16_ms, k2_16_plain, k2_16_bound = check_sums(points, plan16, f"2^16-point MSM c={c_msm}")
    k2_err.append(err)

    res, t_msm = timed(lambda: g1.to_affine(pippenger.msm(points, scalars)))
    got = None if bool(res.inf) else (FQ.to_int(res.x), FQ.to_int(res.y))
    host_pts = g1.to_host(points)
    host_sc = [int(v) for v in FR.to_int(scalars, mont=False)]
    if not all(golden.g1_is_on_curve(p) for p in host_pts[:64] if p is not None):
        raise AssertionError("generated points are not on the curve")
    t0 = time.perf_counter()
    want = native.g1_msm_native(host_pts, host_sc)
    t_native = time.perf_counter() - t0
    if got != want:
        raise AssertionError("2^16-point MSM differs from the native host Pippenger")
    _, t_msm2 = timed(lambda: g1.to_affine(pippenger.msm(points, scalars)))
    log(f"phase 3 msm: 2^16 points equal to native g1_msm_native; card {t_msm:.3f} s "
        f"(first call), {t_msm2:.3f} s (second); host native {t_native:.3f} s")

    g2rng = random.Random(3)
    g2_pts = [golden.g2_mul(golden.G2_GEN, g2rng.randrange(1, gp.P)) for _ in range(G2_MSM_N)]
    g2_pts[1] = None
    g2_sc = [g2rng.randrange(gp.P) for _ in range(G2_MSM_N - 1)] + [0]
    want = None
    for p_, k_ in zip(g2_pts, g2_sc):
        want = golden.g2_add(want, None if p_ is None else golden.g2_mul(p_, k_))
    with Path("msm_g2", uses=("mont_mul",)) as g2_path:
        res, t_g2 = timed(lambda: g2.to_affine(pippenger.msm_g2(
            g2.from_host(g2_pts, dev), FR.from_int(g2_sc, mont=False, device=dev)).map(lambda a: a[None])))
    paths["msm_g2"] = g2_path.launches
    if g2.to_host(res) != [want]:
        raise AssertionError("G2 MSM differs from golden G2 multiples summed on the host")
    log(f"phase 3 msm_g2: {G2_MSM_N} G2 points (one at infinity, one zero scalar) equal to golden "
        f"g2_mul sums; card {t_g2:.3f} s; kernel launches {g2_path.launches}; the first kernel-1 launch "
        f"of each of {len(g2_path.k1_err)} operand shapes equal to mont_mul_plain as it ran")

    # -- phase 4: pinned vectors -----------------------------------------------------------
    with open(os.path.join(ROOT, "tests", "vectors", "pinned_v1.json")) as f:
        vectors = json.load(f)
    makers = {"example1": example_circuit_1, "example2": example_circuit_2}
    for vname in ("example1", "example2"):
        vec = vectors[vname]
        r = vec["rnd"]
        rnd = gp.Randomness(cns=r["cns"], y=r["y"], z=r["z"], ys=r["ys"], zs=r["zs"], u=r["u"], v=r["v"])
        circuit, assignment = makers[vname](x=1, z=2)
        srs = SRS.from_host(gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"]), device=dev)
        dc = DeviceCircuit.from_host(circuit, device=dev)
        (proof, oracle), t_prove = timed(
            lambda: protocol.prove(srs, DeviceAssignment.from_host(assignment, device=dev), dc, rnd)
        )
        if serial.proof_to_bytes(proof).hex() != vec["proof_hex"]:
            raise AssertionError(f"{vname}: proof bytes differ from pinned_v1.json")
        if not protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
            raise AssertionError(f"{vname}: verify returned False")
        proof.pr_a = (proof.pr_a + 1) % gp.P
        if protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
            raise AssertionError(f"{vname}: tampered proof verified")
        log(f"phase 4 {vname}: proof bytes equal pinned_v1.json, verify True, tampered False "
            f"(prove {t_prove:.2f} s)")

    # -- phase 5: main path, BASELINE config 2 ------------------------------------------------
    n, q = MAIN_N, MAIN_Q
    rng = random.Random(42)
    circuit, assignment = random_circuit(rng, n=n, q=q)
    d = 7 * n + 20
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    srs, t_srs = timed(lambda: SRS.new(d, x, alpha, h_mode="verifier", n_hints=[n], device=dev))
    (dc, da), t_up = timed(lambda: (DeviceCircuit.from_host(circuit, device=dev),
                                    DeviceAssignment.from_host(assignment, device=dev)))
    rnd = gp.Randomness.generate(rng, m=q)
    log(f"phase 5 main path: n={n} q={q} d={d}; SRS.new (verifier mode, G1 tables on the card, "
        f"fixed-base) {t_srs:.2f} s, circuit upload {t_up:.2f} s")

    with Path("prove + verify") as main_path:
        (proof, oracle), t_warm = timed(lambda: protocol.prove(srs, da, dc, rnd))
        ok, t_verify = timed(lambda: protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs))
    paths["prove + verify"] = main_path.launches
    log(f"phase 5 prove (warm-up) {t_warm:.2f} s, verify {t_verify:.3f} s; "
        f"kernel launches in prove + verify: {main_path.launches}")
    if not ok:
        raise AssertionError("main path: verify returned False")
    backend = "native C++ (sonic_tpu_torch/_build)" if native.get_lib() is not None else "pure Python"
    times = []
    for _ in range(PROVE_RUNS):
        (proof2, _), t = timed(lambda: protocol.prove(srs, da, dc, rnd))
        times.append(t)
    if serial.proof_to_bytes(proof2) != serial.proof_to_bytes(proof):
        raise AssertionError("main path: repeated proofs differ")
    log(f"phase 5 prove x{PROVE_RUNS}: median {statistics.median(times):.3f} s, min {min(times):.3f} s "
        f"({', '.join(f'{t:.3f}' for t in times)}); verify {t_verify:.3f} s via {backend} pairing")

    with breakdown.phase_timers(dev) as acc:
        (proof3, _), t_phases = timed(lambda: protocol.prove(srs, da, dc, rnd))
    if serial.proof_to_bytes(proof3) != serial.proof_to_bytes(proof):
        raise AssertionError("main path: the proof under phase timers differs")
    log(f"phase 5 phase breakdown of one prove (sonic_tpu_torch.breakdown timers), {t_phases:.3f} s:")
    for line in breakdown.phase_table(acc):
        log(line)

    # pr_r and pr_t recomputed on the host: native MSM over the SRS rows
    def host_commit(srs, maxm, poly):
        d = srs.d
        lo = poly.offset + d - maxm
        sl = slice(lo + d, lo + d + poly.length)
        rows = g1.to_host(Affine(srs.g_ax.x[sl], srs.g_ax.y[sl], srs.g_ax.inf[sl]))
        return native.g1_msm_native(rows, [int(v) for v in FR.to_int(poly.coeffs)])

    cns = FR.from_int(rnd.cns, device=dev)
    y_m = FR.from_int(rnd.y, device=dev)
    r1 = r_x1_poly(da, cns)
    t_y = laurent.mul(r1, laurent.add(r_at_y(r1, y_m), s_at_y(dc, y_m)))
    tc = t_y.coeffs.clone()
    tc[-t_y.offset] = limb.sub(tc[-t_y.offset], k_at_y(dc, n, y_m), FR)
    if host_commit(srs, n, r1) != proof.pr_r:
        raise AssertionError("pr_r differs from the native host MSM")
    if host_commit(srs, d, laurent.Laurent(t_y.offset, tc)) != proof.pr_t:
        raise AssertionError("pr_t differs from the native host MSM")
    proof.pr_a = (proof.pr_a + 1) % gp.P
    if protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
        raise AssertionError("main path: tampered proof verified")
    log("phase 5 checks: verify True, tampered False, pr_r and pr_t equal to native host MSMs")

    # the kernels at a path's own shapes, against their plain versions
    k1_err = [k1["Fr"][0], k1["Fq"][0]] + g2_path.k1_err

    def k1_checked(path, label):
        k1_err.extend(path.k1_err)
        log(f"{label} kernel 1: the first launch of each of {len(path.k1_err)} operand shapes "
            f"equal to mont_mul_plain as it ran (max abs err {max(path.k1_err, default=0)})")

    k1_checked(main_path, "phase 5")
    # the most-launched shape timed on random operands of its shapes
    top = max(main_path.shape_count, key=main_path.shape_count.get)
    spec = {FR.name: FR, FQ.name: FQ}[top[0]]
    a, b = (rand_canonical(spec, max(1, math.prod(s_[:-1]))).reshape(s_) for s_ in top[1:])
    nout = torch.broadcast_shapes(a.shape, b.shape).numel()
    top_ms = event_ms(lambda: mont_mul.mont_mul(a, b, spec), 200)
    top_plain = event_ms(lambda: mont_mul.mont_mul_plain(a, b, spec), 20)
    top_bound = k1_bound_ms(a, b, nout)
    log(f"phase 5 kernel 1 most-launched shape {spec.name} {tuple(a.shape)} x {tuple(b.shape)} "
        f"({main_path.shape_count[top]} of {sum(main_path.shape_count.values())} launches; "
        f"random operands): kernel {top_ms:.4f} ms, plain {top_plain:.3f} ms, byte bound {top_bound:.5f} ms")

    log(f"phase 5 kernel 2: the {len(main_path.sums)} bucket-sums launches of the counted run:")
    k2_main = None
    largest = max(p.entries for _, p in main_path.sums)
    for i, (pts, plan) in enumerate(main_path.sums):
        label = f"launch {i} {plan.shape} (M, W, B) over N={plan.npoints}"
        # time the first launch of the largest plan: the helper's batched one
        time_it = k2_main is None and plan.entries == largest
        err, ms, plain_ms, bound = check_sums(pts, plan, label, time_it)
        k2_err.append(err)
        if time_it:
            k2_main = (ms, plain_ms, bound)
    del main_path

    # kernel 3 on the inputs of one more prove's tail: its window combine
    # (R = 4m + 7 MSMs) and its weighted sum with the most rows (the
    # helper's M = 64 MSMs), held against the plain twins on the same
    # tensors; the serial chain's time is the kernel's on one row
    tails = {}
    real_ws, real_wc = pippenger._bucket_weighted_sum, pippenger._window_combine

    def ws_keep(buckets, group=g1):
        if group is g1 and buckets.x.numel() > (tails["ws"].x.numel() if "ws" in tails else 0):
            tails["ws"] = buckets
        return real_ws(buckets, group)

    def wc_keep(totals, c, group=g1):
        tails.setdefault("wc", (totals, c))
        return real_wc(totals, c, group)

    pippenger._bucket_weighted_sum, pippenger._window_combine = ws_keep, wc_keep
    try:
        protocol.prove(srs, da, dc, rnd)
    finally:
        pippenger._bucket_weighted_sum, pippenger._window_combine = real_ws, real_wc
    wc_in, wc_c = tails["wc"]
    ws_in = tails["ws"]
    wc_rows, W_ = wc_in.x.shape[0], wc_in.x.shape[-2]
    ws_rows, B_ = ws_in.x[..., 0, 0].numel(), ws_in.x.shape[-2]
    k3 = {}
    for kname, kern, plain, one, rows, products in (
        ("window_combine", lambda: tail.window_combine(wc_in, wc_c),
         lambda: tail.window_combine_plain(wc_in, wc_c),
         lambda: tail.window_combine(wc_in.map(lambda a: a[:1]), wc_c),
         wc_rows, (W_ - 1) * (wc_c * 8 + 12)),
        ("bucket_weighted_sum", lambda: tail.bucket_weighted_sum(ws_in),
         lambda: tail.bucket_weighted_sum_plain(ws_in),
         lambda: tail.bucket_weighted_sum(ws_in.map(lambda a: a.reshape(-1, B_, FQ.nlimbs)[:1])),
         ws_rows, 2 * (B_ - 1) * 12),
    ):
        got, want = kern(), plain()
        if kname == "bucket_weighted_sum":
            got, want = g1.to_affine(got), g1.to_affine(want)
        sync()
        if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
            raise AssertionError(f"kernel 3 {kname} over {rows} rows differs from its plain twin")
        err = max(int((g_.long() - w_.long()).abs().max()) for g_, w_ in zip(got, want))
        ms, plain_ms, chain_ms = event_ms(kern, 10), event_ms(plain, 2), event_ms(one, 10)
        bound = rows * products * 4 * FQ_WORDS * FQ_WORDS / imad_per_ms
        k3[kname] = {"rows": rows, "products_a_row": products, "ms": ms, "plain_ms": plain_ms,
                     "imad_bound_ms": bound, "chain_ms": chain_ms, "max_abs_err": err}
        log(f"phase 5 kernel 3 {kname}: {rows} rows ({products} dependent Fq products a row), equal to its "
            f"plain twin ({'in projective form' if kname == 'window_combine' else 'affine'}); kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms; one row alone (the serial chain) {chain_ms:.3f} ms, "
            f"multiply-add bound {bound:.4f} ms")
    del tails, wc_in, ws_in, got, want

    # -- phase 6: full SRS at d = 2^16 ----------------------------------------------------------
    srng = random.Random(6)
    sx, salpha = srng.randrange(2, gp.P), srng.randrange(2, gp.P)
    # a synchronizing timer around each group's window table and
    # fixed_base_mul inside SRS.new (the G1 table is cached from phase 5)
    parts = {}

    def fixed_base_timed(group, scalars):
        _, parts[f"{group.name} window table"] = timed(
            lambda: fixed_base.table(group, fixed_base.DEFAULT_C, scalars.device))
        out, parts[f"{group.name} fixed_base_mul ({scalars.shape[0]} points)"] = timed(
            lambda: fixed_base.fixed_base_mul(group, scalars))
        return out

    srs_module.fixed_base_mul = fixed_base_timed
    try:
        with Path("SRS.new full", uses=("mont_mul",)) as srs_path:
            full, t_full = timed(lambda: SRS.new(SRS_D, sx, salpha, h_mode="full", device=dev))
    finally:
        srs_module.fixed_base_mul = fixed_base.fixed_base_mul
    paths["SRS.new full"] = srs_path.launches
    rows = 2 * SRS_D + 1
    log(f"phase 6 full SRS: SRS.new(h_mode='full') d={SRS_D} ({rows} rows a table) {t_full:.2f} s; "
        f"kernel launches: {srs_path.launches}; of it "
        + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f", the rest (powers of x, from_mont, two to_affine) {t_full - sum(parts.values()):.3f} s")

    def row_scalar(d, x, alpha, table, i):
        """The exponent of row i (e = i - d) of a table, as an int mod P."""
        e = i - d
        s = pow(x, e, gp.P)
        if table in ("g_ax", "h_ax"):
            s = alpha * s % gp.P
        return 0 if table == "g_ax" and e == 0 else s

    def scalar(table, i):
        return row_scalar(SRS_D, sx, salpha, table, i)

    def table_rows(tab, idx):
        it = torch.tensor(idx, device=dev)
        return Affine(tab.x[it], tab.y[it], tab.inf[it])

    def golden_rows(srs, x, alpha, idx, label):
        """Rows idx of each of the four tables equal to golden.g1_mul/g2_mul."""
        for tname, grp, host_mul, hgen in (("g_x", g1, golden.g1_mul, golden.G1_GEN),
                                           ("g_ax", g1, golden.g1_mul, golden.G1_GEN),
                                           ("h_x", g2, golden.g2_mul, golden.G2_GEN),
                                           ("h_ax", g2, golden.g2_mul, golden.G2_GEN)):
            got = grp.to_host(table_rows(getattr(srs, tname), idx))
            if got != [host_mul(hgen, row_scalar(srs.d, x, alpha, tname, i)) for i in idx]:
                raise AssertionError(f"{label}: {tname} rows differ from golden scalar multiples")

    t0 = time.perf_counter()
    idx = sorted(srng.sample(range(rows), SRS_ROWS_CHECKED - 1) + [SRS_D])  # with e = 0
    golden_rows(full, sx, salpha, idx, "phase 6")
    log(f"phase 6 checks: {len(idx)} rows of each of the 4 tables equal to golden.g1_mul/g2_mul "
        f"on the host ({time.perf_counter() - t0:.1f} s)")

    lidx = sorted(srng.sample(range(rows), LADDER_ROWS))
    lsc = FR.from_int([scalar(t, i) for t in ("g_x", "g_ax") for i in lidx], mont=False, device=dev)
    (ladder, t_ladder) = timed(lambda: g1.to_affine(g1.scalar_mul(base, lsc)))
    for k, tname in enumerate(("g_x", "g_ax")):
        want_rows = table_rows(getattr(full, tname), lidx)
        got_rows = [a[k * LADDER_ROWS:(k + 1) * LADDER_ROWS] for a in ladder]
        if not all(torch.equal(g, w) for g, w in zip(got_rows, want_rows)):
            raise AssertionError(f"phase 6: {tname} differs from the double-and-add ladder")
    log(f"phase 6 checks: {LADDER_ROWS} rows of g_x and of g_ax equal, in affine form, to the "
        f"same scalars through g1.scalar_mul ({t_ladder:.2f} s on the card)")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "srs.npz")
        _, t_save = timed(lambda: serial.save_srs(path, full))
        size = os.path.getsize(path)
        loaded, t_load = timed(lambda: serial.load_srs(path, device=dev))
    for tname in ("g_x", "g_ax", "h_x", "h_ax"):
        if not all(torch.equal(a, b) for a, b in zip(getattr(full, tname), getattr(loaded, tname))):
            raise AssertionError(f"phase 6: {tname} differs after save_srs / load_srs")
    log(f"phase 6 checkpoint: save_srs {t_save:.2f} s ({size / 1e6:.1f} MB), load_srs "
        f"{t_load:.2f} s, all four tables equal")
    del loaded, ladder

    for vname in ("example1", "example2"):
        vec = vectors[vname]
        vsrs, t_v = timed(lambda: SRS.new(vec["d"], vec["x"], vec["alpha"], h_mode="full", device=dev))
        if srs_digest(vsrs.to_host()) != vec["srs_sha256"]:
            raise AssertionError(f"phase 6: {vname} SRS digest differs from pinned_v1.json")
        log(f"phase 6 {vname}: SRS.new(h_mode='full') d={vec['d']} on the card ({t_v:.2f} s) "
            "gives the pinned srs_sha256")
    k1_checked(srs_path, "phase 6")
    full_digest = table_digest(full)
    del full, srs_path

    # -- phase 7: batch proving, BASELINE config 5 at n = 2^10 ------------------------------------
    brng = random.Random(7)
    B, bq = BATCH_B, BATCH_Q
    bpairs = [random_circuit(brng, n=n, q=bq) for _ in range(B)]
    brnds = [gp.Randomness.generate(brng, m=bq) for _ in range(B)]
    (bdcs, bdas), t_bup = timed(lambda: (
        [DeviceCircuit.from_host(c_, device=dev) for c_, _ in bpairs],
        [DeviceAssignment.from_host(a_, device=dev) for _, a_ in bpairs]))
    log(f"phase 7 batch: B={B} random circuits n={n} q={bq} on phase 5's SRS (d={d}); "
        f"upload {t_bup:.2f} s")
    with Path("prove_batch") as batch_path:
        batch, t_bwarm = timed(lambda: protocol.prove_batch(srs, bdas, bdcs, brnds))
    paths["prove_batch"] = batch_path.launches
    log(f"phase 7 prove_batch (warm-up) {t_bwarm:.2f} s; kernel launches: {batch_path.launches}")
    btimes = []
    for _ in range(PROVE_RUNS):
        batch2, t = timed(lambda: protocol.prove_batch(srs, bdas, bdcs, brnds))
        btimes.append(t)
    bbytes = [serial.proof_to_bytes(p) for p, _ in batch]
    if [serial.proof_to_bytes(p) for p, _ in batch2] != bbytes:
        raise AssertionError("phase 7: repeated batches differ")
    del batch2
    log(f"phase 7 prove_batch x{PROVE_RUNS}: median {statistics.median(btimes):.3f} s, "
        f"min {min(btimes):.3f} s ({', '.join(f'{t:.3f}' for t in btimes)}); "
        f"{B / statistics.median(btimes):.2f} proofs/s at the median")
    with breakdown.phase_timers(dev, breakdown.PHASES + breakdown.BATCH_PHASES) as acc:
        batch3, t_bphases = timed(lambda: protocol.prove_batch(srs, bdas, bdcs, brnds))
    if [serial.proof_to_bytes(p) for p, _ in batch3] != bbytes:
        raise AssertionError("phase 7: the batch under phase timers differs")
    del batch3
    log(f"phase 7 phase breakdown of one prove_batch (sonic_tpu_torch.breakdown timers), "
        f"{t_bphases:.3f} s:")
    for line in breakdown.phase_table(acc):
        log(line)
    t0 = time.perf_counter()
    for b, (p, o) in enumerate(batch):
        if not protocol.verify(srs, bdcs[b], p, o.y, o.z, o.yzs):
            raise AssertionError(f"phase 7: proof {b} of the batch does not verify")
    t_bver = time.perf_counter() - t0
    bad = B // 2
    p, o = batch[bad]
    p.pr_b = (p.pr_b + 1) % gp.P
    if protocol.verify(srs, bdcs[bad], p, o.y, o.z, o.yzs):
        raise AssertionError(f"phase 7: tampered proof {bad} verified")
    for b in (0, B - 1):
        single, _ = protocol.prove(srs, bdas[b], bdcs[b], brnds[b])
        if serial.proof_to_bytes(single) != bbytes[b]:
            raise AssertionError(f"phase 7: proof {b} differs from protocol.prove")
    log(f"phase 7 checks: all {B} proofs verify True ({t_bver:.2f} s), tampered proof {bad} False, "
        f"proofs 0 and {B - 1} byte-equal to protocol.prove")

    k1_checked(batch_path, "phase 7")
    sums = list(enumerate(batch_path.sums))
    largest = max(sums, key=lambda s: s[1][1].entries)[0]
    firsts = {}
    for i, (_, plan) in sums:
        firsts.setdefault(plan.shape, i)
    must = {largest, *firsts.values()}
    order = sorted(must) + [i for i, _ in sums if i not in must]
    t0 = time.perf_counter()
    checked = []
    for i in order:
        if i not in must and time.perf_counter() - t0 > PLAIN_BUDGET_S:
            break
        pts, plan = batch_path.sums[i]
        err = check_sums(pts, plan, f"launch {i} {plan.shape} (M, W, B) over N={plan.npoints}",
                         time_it=i == largest)
        k2_err.append(err[0])
        if i == largest:
            k2_batch = err[1:]
        checked.append(i)
    which = ("every launch" if len(checked) == len(sums) else
             f"the largest (launch {largest}) and the first of each (M, W, B) shape, then launches "
             f"in order until the {PLAIN_BUDGET_S:.0f} s budget ran out")
    log(f"phase 7 kernel 2: {len(checked)} of the batch's {len(sums)} bucket-sums launches equal "
        f"to bucket_sums_plain ({which}: launches {sorted(checked)}; "
        f"{time.perf_counter() - t0:.1f} s)")
    del batch_path, batch, sums

    # -- phase 8: Fiat-Shamir device prover -------------------------------------------------------
    vec = vectors["example2"]
    circuit2, assignment2 = example_circuit_2(x=1, z=2)
    host2 = gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"])
    blinding = [srng.randrange(1, gp.P) for _ in range(4)]
    nizk = fiat_shamir.prove_device(SRS.from_host(host2, device=dev),
                                    DeviceAssignment.from_host(assignment2, device=dev),
                                    DeviceCircuit.from_host(circuit2, device=dev), blinding)
    want = fiat_shamir.prove(host2, assignment2, circuit2, blinding)
    if serial.proof_to_bytes(nizk.proof) != serial.proof_to_bytes(want.proof) or nizk != want:
        raise AssertionError("phase 8: prove_device on example2 differs from the host fiat_shamir.prove")
    if not fiat_shamir.verify(host2, circuit2, nizk):
        raise AssertionError("phase 8: fiat_shamir.verify returned False on example2")
    log("phase 8 example2: prove_device byte-equal to the host fiat_shamir.prove, verify True")

    with Path("fiat_shamir.prove_device") as fs_path:
        nizk, t_fs = timed(lambda: fiat_shamir.prove_device(srs, da, dc, blinding))
    paths["fiat_shamir.prove_device"] = fs_path.launches
    hsc = nizk.proof.pr_hsc
    frnd = gp.Randomness(cns=blinding, y=nizk.y, z=nizk.z, ys=[y_ for y_, _ in nizk.yzs],
                         zs=[z_ for _, z_ in nizk.yzs], u=hsc.hsc_u, v=hsc.hsc_v)
    fproof, _ = protocol.prove(srs, da, dc, frnd)
    if serial.proof_to_bytes(fproof) != serial.proof_to_bytes(nizk.proof):
        raise AssertionError("phase 8: prove_device differs from protocol.prove at its challenges")
    if not protocol.verify(srs, dc, nizk.proof, nizk.y, nizk.z, nizk.yzs):
        raise AssertionError("phase 8: protocol.verify returned False on the FS proof")
    log(f"phase 8 n={n} q={q}: prove_device {t_fs:.3f} s, equal to protocol.prove with its "
        f"derived challenges, verify True; kernel launches: {fs_path.launches}")
    k1_checked(fs_path, "phase 8")
    for i, (pts, plan) in enumerate(fs_path.sums):
        k2_err.append(check_sums(pts, plan, f"phase 8 launch {i} {plan.shape} (M, W, B) over "
                                            f"N={plan.npoints}", time_it=False)[0])
    del fs_path, pts, plan

    # -- phase 9: multi-rank ------------------------------------------------------------------
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    import torch.multiprocessing as mp

    # the ranks share the card with this process: hand back its allocator's cache
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    log(f"phase 9: this process's reserved device memory {reserved / 2**30:.1f} GiB -> "
        f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB before the ranks start")

    with tempfile.TemporaryDirectory() as tmp:
        refs = {
            "main": (n, q, d, x, alpha, circuit, assignment, rnd, serial.proof_to_bytes(proof2),
                     table_digest(srs, ("g_x", "g_ax"))),
            "full": (SRS_D, sx, salpha, full_digest),
            "batch": (bpairs, brnds, bbytes),
        }
        with open(os.path.join(tmp, "refs.pkl"), "wb") as f:
            pickle.dump(refs, f)
        t0 = time.perf_counter()
        ctx = mp.start_processes(multi_rank, args=(WORLD, backend, tmp), nprocs=WORLD, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > WORLD_TIMEOUT_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"phase 9: the ranks did not finish in {WORLD_TIMEOUT_S} s")
        t_world = time.perf_counter() - t0
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    paths["multi_rank"] = {k: sum(rk["launches"][k] for rk in ranks)
                           for k in ("mont_mul", "bucket_sums", "msm_tail", "poly_div")}
    k1_err.extend(ranks[0]["k1_err"])
    k2_err.extend(ranks[0]["k2_err"])
    r0 = ranks[0]
    how = ("gloo's own CUDA collectives, which pass through host memory; the port stages nothing"
           if backend == "gloo" else "NCCL")
    log(f"phase 9 multi-rank: backend {backend}, world {WORLD}, devices "
        f"{[rk['device'] for rk in ranks]} ({how}); {t_world:.1f} s for the ranks, start-up included")
    log(f"phase 9 checks on every rank: SRS.new(mesh) verifier d={d} G1 tables = phase 5's, full "
        f"d={SRS_D} all four tables = phase 6's; prove(mesh) n={n} q={q} = phase 5's bytes (warm-up "
        f"and timed), verify True, sharded four-step NTT calls a prove {r0['sharded_ntts']}; "
        f"prove_batch(mesh) B={B} = phase 7's {B} proofs; kernel launches by rank "
        f"{[rk['launches'] for rk in ranks]}")
    log(f"phase 9 rank 0 ({card}; {WORLD} ranks sharing one card: no scaling figure): SRS.new(mesh) "
        f"verifier d={d} {r0['t_srs_v']:.3f} s, full d={SRS_D} {r0['t_srs_full']:.3f} s; prove(mesh) "
        f"warm-up {r0['t_warm']:.3f} s, timed {r0['t_prove']:.3f} s; prove_batch(mesh) "
        f"{r0['t_batch']:.3f} s; peak device memory by rank "
        f"{[round(rk['peak_gib'], 1) for rk in ranks]} GiB")
    for what in ("prove", "srs_v", "srs_full"):
        rows = ", ".join(f"{k} {v[0]:.4f} s in {v[1]} calls" for k, v in r0[f"coll_{what}"].items())
        log(f"phase 9 rank 0 collectives in the timed {what}: {rows}")
    log(f"phase 9 rank 0 kernels: first kernel-2 launch equal to bucket_sums_plain (max abs err "
        f"{max(r0['k2_err'])}), first kernel-1 launch of each of {len(r0['k1_err'])} operand shapes "
        f"equal to mont_mul_plain (max abs err {max(r0['k1_err'])})")

    # -- phase 10: big, BASELINE config 3 (bench.py's _bench_big_roundtrip) -------------------
    # this process's tensors of the earlier phases go first, then its allocator's cache
    del points, plan16, small, digits, msm_digits, scalars, host_pts, a, b, base, aff
    del srs, dc, da, bdcs, bdas, bpairs, refs, nizk, fproof, proof, proof2, proof3, r1, t_y, tc
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    n, q = BIG_N, BIG_Q
    rng = random.Random(77)
    circuit, assignment = random_circuit(rng, n=n, q=q)
    (dc, da), t_up = timed(lambda: (DeviceCircuit.from_host(circuit, device=dev),
                                    DeviceAssignment.from_host(assignment, device=dev)))
    d = 7 * n + 20
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    gen_srs, t_srs = timed(lambda: SRS.new(d, x, alpha, h_mode="verifier", n_hints=[n], device=dev))
    digest = table_digest(gen_srs, ("g_x", "g_ax"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "srs.npz")
        _, t_save = timed(lambda: serial.save_srs(path, gen_srs))
        size = os.path.getsize(path)
        del gen_srs
        srs, t_load = timed(lambda: serial.load_srs(path, device=dev))
    if table_digest(srs, ("g_x", "g_ax")) != digest:
        raise AssertionError("phase 10: the loaded SRS's G1 tables differ from the generated ones")
    rnd = gp.Randomness.generate(rng, m=q)
    log(f"phase 10 big: random_circuit(Random(77), n={n}, q={q}), d={d}; circuit upload {t_up:.2f} s, "
        f"SRS.new (verifier mode) {t_srs:.2f} s, save_srs {t_save:.2f} s ({size / 1e6:.1f} MB), "
        f"load_srs {t_load:.2f} s, loaded G1 tables' digest equal to the generated ones'")

    with Path("big prove + verify", sums_by_shape=True) as big_path:
        (proof, oracle), t_warm = timed(lambda: protocol.prove(srs, da, dc, rnd))
        ok, t_verify = timed(lambda: protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs))
    paths["big prove + verify"] = big_path.launches
    if not ok:
        raise AssertionError("phase 10: verify returned False")
    log(f"phase 10 prove (warm-up) {t_warm:.2f} s, verify {t_verify:.3f} s (kernel-1 checks left out); "
        f"kernel launches in prove + verify: {big_path.launches}")
    k1_checked(big_path, "phase 10")

    # kernel 2: the first launch of each (M, W, B, N), smallest first; the
    # smallest and a full helper slice (the most points, then the most MSMs)
    # always, that slice timed with the largest single MSM
    sums = sorted(big_path.sums, key=lambda s_: s_[1].entries)
    row_src = big_path.row_src
    del big_path
    slice_i = max((i for i, (_, p_) in enumerate(sums) if p_.shape[0] > 1),
                  key=lambda i: (sums[i][1].npoints, sums[i][1].shape[0]))
    single_i = max((i for i, (_, p_) in enumerate(sums) if p_.shape[0] == 1), key=lambda i: sums[i][1].entries)
    must = {0, slice_i}
    t0 = time.perf_counter()
    checked, big_k2 = [], {}
    for i in sorted(must) + [i for i in range(len(sums)) if i not in must]:
        if i not in must and time.perf_counter() - t0 > BIG_PLAIN_BUDGET_S:
            continue
        pts, plan = sums[i]
        label = f"launch {plan.shape} (M, W, B) over N={plan.npoints}"
        err = check_sums(pts, plan, label, time_it=i in (slice_i, single_i))
        k2_err.append(err[0])
        if i in (slice_i, single_i):
            big_k2["slice" if i == slice_i else "single"] = (plan.shape, plan.npoints, plan.entries) + err[1:]
        checked.append(i)
    if single_i not in checked:  # timed even when the budget skipped its plain check
        pts, plan = sums[single_i]
        big_k2["single"] = (plan.shape, plan.npoints, plan.entries,
                            event_ms(lambda: bucket_acc.bucket_sums(pts, plan), 3), None, k2_bound_ms(plan))
    log(f"phase 10 kernel 2: {len(checked)} of the {len(sums)} distinct (M, W, B, N) launches equal to "
        f"bucket_sums_plain (smallest first; the smallest and a helper slice always, the rest while the "
        f"{BIG_PLAIN_BUDGET_S:.0f} s budget lasted; {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    rows_checked = [i for i in range(len(sums)) if i not in checked]
    for i in rows_checked:
        t1 = time.perf_counter()
        pts, plan = sums[i]
        k2_err.append(row_err(pts, plan, bucket_acc.bucket_sums(pts, plan), row_src[(plan.shape, plan.npoints)]))
        log(f"  kernel 2 launch {plan.shape} (M, W, B) over N={plan.npoints}, E={plan.entries}: MSM row "
            f"{plan.shape[0] - 1} equal, in affine form, to bucket_sums_plain on that row's own plan "
            f"({time.perf_counter() - t1:.1f} s)")
    log(f"phase 10 kernel 2: the other {len(rows_checked)} launches checked on their last MSM row "
        f"({time.perf_counter() - t0:.1f} s): all {len(sums)} shapes held")
    del sums, pts, plan, row_src

    # the timed prove's peak is its own: the kept launches are gone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (proof2, _), t_prove = timed(lambda: protocol.prove(srs, da, dc, rnd))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if serial.proof_to_bytes(proof2) != serial.proof_to_bytes(proof):
        raise AssertionError("phase 10: repeated proofs differ")
    log(f"phase 10 prove (timed) {t_prove:.3f} s, peak device memory {peak:.2f} GiB "
        f"(limit {BIG_PEAK_GIB:.0f} GiB; the SRS and circuit on the card included); "
        f"{n / t_prove:.0f} gates/s")
    if peak > BIG_PEAK_GIB:
        raise AssertionError(f"phase 10: the prove's peak device memory {peak:.2f} GiB exceeds "
                             f"{BIG_PEAK_GIB} GiB")
    with breakdown.phase_timers(dev) as acc:
        (proof3, _), t_phases = timed(lambda: protocol.prove(srs, da, dc, rnd))
    if serial.proof_to_bytes(proof3) != serial.proof_to_bytes(proof):
        raise AssertionError("phase 10: the proof under phase timers differs")
    log(f"phase 10 phase breakdown of one prove (sonic_tpu_torch.breakdown timers), {t_phases:.3f} s:")
    for line in breakdown.phase_table(acc):
        log(line)
    del proof2, proof3

    t0 = time.perf_counter()
    cns, y_m = FR.from_int(rnd.cns, device=dev), FR.from_int(rnd.y, device=dev)
    r1 = r_x1_poly(da, cns)
    t_y = laurent.mul(r1, laurent.add(r_at_y(r1, y_m), s_at_y(dc, y_m)))
    tc = t_y.coeffs.clone()
    tc[-t_y.offset] = limb.sub(tc[-t_y.offset], k_at_y(dc, n, y_m), FR)
    if host_commit(srs, n, r1) != proof.pr_r:
        raise AssertionError("phase 10: pr_r differs from the native host MSM")
    if host_commit(srs, d, laurent.Laurent(t_y.offset, tc)) != proof.pr_t:
        raise AssertionError("phase 10: pr_t differs from the native host MSM")
    del r1, t_y, tc
    s_j = s_at_y_batched(dc, FR.from_int([rnd.ys[0], rnd.ys[q - 1]], device=dev))
    for k, j in enumerate((0, q - 1)):
        if host_commit(srs, d, laurent.Laurent(-n, s_j[k])) != proof.pr_hsc.hsc_s[j][0]:
            raise AssertionError(f"phase 10: helper commitment {j} differs from the native host MSM")
    del s_j
    proof.pr_a = (proof.pr_a + 1) % gp.P
    if protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
        raise AssertionError("phase 10: tampered proof verified")
    log(f"phase 10 checks: verify True, tampered False; pr_r, pr_t and helper commitments 0 and "
        f"{q - 1} equal to native host MSMs over the same SRS rows ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 10: {time.perf_counter() - t10:.1f} s for the phase, circuit generation included")

    # -- phase 11: batch at n = 2^16, BASELINE config 5 (bench.py's _bench_prove_batch) ---------
    del dc, da, proof, oracle, circuit, assignment
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    B, bq = BIG_BATCH_B, BIG_BATCH_Q
    brng = random.Random(88)
    t0 = time.perf_counter()
    bpairs = [random_circuit(brng, n=n, q=bq) for _ in range(B)]
    brnds = [gp.Randomness.generate(brng, m=bq) for _ in range(B)]
    t_gen = time.perf_counter() - t0
    (bdcs, bdas), t_bup = timed(lambda: (
        [DeviceCircuit.from_host(c_, device=dev) for c_, _ in bpairs],
        [DeviceAssignment.from_host(a_, device=dev) for _, a_ in bpairs]))
    del bpairs
    log(f"phase 11 big batch: B={B} random_circuit(Random(88), n={n}, q={bq}) on phase 10's SRS "
        f"(d={d}); host generation {t_gen:.2f} s, upload {t_bup:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card with the SRS")
    before = collections.Counter(protocol.helper_slicings)
    with Path("big prove_batch", check_sums_s=BIG_BATCH_PLAIN_BUDGET_S) as bb_path:
        bbatch, t_bb = timed(lambda: protocol.prove_batch(srs, bdas, bdcs, brnds))
    paths["big prove_batch"] = bb_path.launches
    (_, nslices), = (protocol.helper_slicings - before).keys()
    bb_peak = bb_path.peak / 2**30
    log(f"phase 11 prove_batch {t_bb:.3f} s (kernel checks left out), {B / t_bb:.3f} proofs/s, "
        f"{B * n / t_bb:.0f} gates/s; peak device memory {bb_peak:.2f} GiB (limit {BIG_PEAK_GIB:.0f} GiB; "
        f"the SRS and the {B} circuits on the card included); the helper in {nslices} slices of the "
        f"proofs; kernel launches: {bb_path.launches}")
    if bb_peak > BIG_PEAK_GIB:
        raise AssertionError(f"phase 11: the batch's peak device memory {bb_peak:.2f} GiB exceeds "
                             f"{BIG_PEAK_GIB} GiB")
    k1_checked(bb_path, "phase 11")
    k2_err.extend(bb_path.k2_err)
    big_batch_k2 = []
    for row in bb_path.k2_new:
        row["bound_ms"] = row["entries"] * IMAD_PER_MIXED_ADD / imad_per_ms
        big_batch_k2.append(row)
        plain = (f"{row['plain_ms']:.1f} ms, equal" if row["plain_ms"] is not None else
                 f"on MSM row {row['shape'][0] - 1} alone {row['row_plain_ms']:.1f} ms, equal in affine form")
        log(f"  kernel 2 {tuple(row['shape'])} (M, W, B) over N={row['npoints']}, E={row['entries']}: "
            f"{row['ms']:.3f} ms as it ran (bound {row['bound_ms']:.3f} ms, "
            f"{100 * row['bound_ms'] / row['ms']:.1f} %); bucket_sums_plain {plain}")
    checked = sum(r_["plain_ms"] is not None for r_ in big_batch_k2)
    log(f"phase 11 kernel 2: the first launch of {checked} of the {len(big_batch_k2)} distinct (M, W, B, N) "
        f"equal to bucket_sums_plain as it ran (the first always, the rest while the "
        f"{BIG_BATCH_PLAIN_BUDGET_S:.0f} s budget lasted), the other {len(big_batch_k2) - checked} on their "
        f"last MSM row: all {len(big_batch_k2)} shapes held")
    idx = B // 2
    (single, _), t_single = timed(lambda: protocol.prove(srs, bdas[idx], bdcs[idx], brnds[idx]))
    if serial.proof_to_bytes(single) != serial.proof_to_bytes(bbatch[idx][0]):
        raise AssertionError(f"phase 11: proof {idx} of the batch differs from protocol.prove")
    t0 = time.perf_counter()
    for b, (p, o) in enumerate(bbatch):
        if not protocol.verify(srs, bdcs[b], p, o.y, o.z, o.yzs):
            raise AssertionError(f"phase 11: proof {b} of the batch does not verify")
    t_bver = time.perf_counter() - t0
    p, o = bbatch[0]
    p.pr_a = (p.pr_a + 1) % gp.P
    if protocol.verify(srs, bdcs[0], p, o.y, o.z, o.yzs):
        raise AssertionError("phase 11: tampered proof 0 verified")
    log(f"phase 11 checks: proof {idx} byte-equal to protocol.prove ({t_single:.2f} s), all {B} proofs "
        f"verify True ({t_bver:.2f} s), tampered proof 0 False; "
        f"{time.perf_counter() - t11:.1f} s for the phase, circuit generation included")

    # -- phase 12: full SRS.new at the big degree (bench.py's _bench_srs at d = 7n + 20) --------
    del bdcs, bdas, bbatch, brnds, single, srs, p, o
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    frng = random.Random(12)
    fx, falpha = frng.randrange(2, gp.P), frng.randrange(2, gp.P)
    frows = 2 * d + 1
    rows_a_chunk = {grp.name: fixed_base.chunk_rows(grp) for grp in (g1, g2)}
    chunks = {k: -(-2 * frows // r) for k, r in rows_a_chunk.items()}  # the tables' two halves in one batch
    # the bytes a row that budget.BASE_ROW_BYTES stands for: one uncut
    # fixed_base_mul and its to_affine over ROW_PROBE rows (within a chunk)
    def bytes_a_row(fn, *args):
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        sync()
        return out, (torch.cuda.max_memory_allocated() - base) / ROW_PROBE

    probe = []
    for grp in (g1, g2):
        fixed_base.table(grp, fixed_base.DEFAULT_C, dev)
        jac, mul_b = bytes_a_row(fixed_base.fixed_base_mul, grp, rand_canonical(FR, ROW_PROBE))
        aff, aff_b = bytes_a_row(grp.to_affine, jac)
        probe.append(f"{grp.name} {mul_b:.0f} B a row, its to_affine {aff_b:.0f} B "
                     f"(unit {budget.BASE_ROW_BYTES[grp.name]} B)")
        del jac, aff
    log(f"phase 12 fixed_base_mul over {ROW_PROBE} rows, peak device memory above what it was given: "
        + "; ".join(probe))
    with Path("big SRS.new full", uses=("mont_mul",)) as bs_path:
        big_full, t_bfull = timed(lambda: SRS.new(d, fx, falpha, h_mode="full", device=dev))
    paths["big SRS.new full"] = bs_path.launches
    bs_peak = bs_path.peak / 2**30
    log(f"phase 12 full SRS: SRS.new(h_mode='full') d={d} ({frows} rows a table) {t_bfull:.2f} s "
        f"(kernel-1 checks left out); peak device memory {bs_peak:.2f} GiB; fixed_base_mul and to_affine "
        f"in chunks of " + ", ".join(f"{k} {r} rows ({chunks[k]} chunks)" for k, r in rows_a_chunk.items())
        + f"; kernel launches: {bs_path.launches}")
    k1_checked(bs_path, "phase 12")
    t0 = time.perf_counter()
    edges = {i % frows for k, r in rows_a_chunk.items() for c_ in range(1, chunks[k])
             for i in (c_ * r - 1, c_ * r)}
    fidx = sorted(set(frng.sample(range(frows), BIG_SRS_ROWS_CHECKED)) | {0, d, frows - 1} | edges)
    golden_rows(big_full, fx, falpha, fidx, "phase 12")
    log(f"phase 12 checks: {len(fidx)} rows of each of the 4 tables (random ones, e = -d, 0, d and both "
        f"sides of every chunk boundary) equal to golden.g1_mul/g2_mul on the host "
        f"({time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "srs.npz")
        _, t_fsave = timed(lambda: serial.save_srs(path, big_full))
        fsize = os.path.getsize(path)
        floaded, t_fload = timed(lambda: serial.load_srs(path, device=dev))
    for tname in ("g_x", "g_ax", "h_x", "h_ax"):
        if not all(torch.equal(a, b) for a, b in zip(getattr(big_full, tname), getattr(floaded, tname))):
            raise AssertionError(f"phase 12: {tname} differs after save_srs / load_srs")
    del floaded, big_full
    log(f"phase 12 checkpoint: save_srs {t_fsave:.2f} s ({fsize / 1e6:.1f} MB), load_srs {t_fload:.2f} s, "
        f"all four tables equal; {time.perf_counter() - t12:.1f} s for the phase")

    # -- phase 13: the MSMs of BASELINE config 4 at its own size (n = 2^20) ----------------------
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    hn = HUGE_N
    huge_pts, t_hpts = timed(lambda: g1.to_affine(fixed_base.fixed_base_mul(g1, rand_canonical(FR, hn))))
    sizes = {"t": 7 * hn + 8, "helper": 3 * hn + 1}  # t's commitment; the helper's MSMs over 3n + 1 points

    def tiled(N):
        """The 2^20 points repeated to N rows."""
        idx = torch.arange(N, device=dev) % hn
        return Affine(huge_pts.x[idx], huge_pts.y[idx], huge_pts.inf[idx])

    def folded(sc):
        """(N, 16) standard-form scalars -> (2^20, 16): the sum mod r of the
        scalars that meet each of the 2^20 points in `tiled(N)`."""
        acc = sc[:hn].clone()
        for lo in range(hn, sc.shape[0], hn):
            part = sc[lo : lo + hn]
            acc[: part.shape[0]] = limb.add(acc[: part.shape[0]], part, FR)
        return acc

    huge_sc = {k: rand_canonical(FR, N) for k, N in sizes.items()}
    msm_phases = [(pippenger, "_lay_out", "digits"), (pippenger, "make_plan", "plan"),
                  (pippenger, "bucket_sums", "scan (kernel 2)"),
                  (pippenger, "_bucket_weighted_sum", "tail: bucket weighted sum"),
                  (pippenger, "combine_windows", "tail: window combine")]
    cut_before = collections.Counter(pippenger.n_slicings)
    huge_res = {}
    with Path("huge MSMs", uses=("mont_mul", "bucket_sums", "msm_tail"), sums_by_shape=True) as huge_path:
        whole_sc = folded(huge_sc["t"])
        huge_res["whole"], t_whole = timed(lambda: g1.to_affine(pippenger.msm(huge_pts, whole_sc).map(lambda a: a[None])))
        with breakdown.phase_timers(dev, msm_phases) as macc:
            _, t_whole_split = timed(lambda: pippenger.msm(huge_pts, whole_sc))
        for k, N in sizes.items():
            pts_k = tiled(N)
            huge_res[k], t_cut = timed(lambda: g1.to_affine(pippenger.msm(pts_k, huge_sc[k]).map(lambda a: a[None])))
            huge_res[k + " s"] = t_cut
            del pts_k
        helper_ref = folded(huge_sc["helper"])
        huge_res["helper ref"] = g1.to_affine(pippenger.msm(huge_pts, helper_ref).map(lambda a: a[None]))
    paths["huge MSMs"] = huge_path.launches
    cuts = pippenger.n_slicings - cut_before
    for k, ref in (("t", "whole"), ("helper", "helper ref")):
        if not all(torch.equal(g_, w_) for g_, w_ in zip(huge_res[k], huge_res[ref])):
            raise AssertionError(f"phase 13: the {sizes[k]}-point MSM cut along N differs from the uncut "
                                 f"2^20-point MSM of its per-point summed scalars")
    split = ", ".join(f"{label} {macc[label][0]:.3f} s ({macc[label][1]} calls)" for _, _, label in msm_phases)
    log(f"phase 13 huge MSMs (n = 2^20): {hn} G1 points by fixed_base_mul on the card in {t_hpts:.2f} s; "
        f"the 2^20-point MSM whole {t_whole:.3f} s, under sync timers {t_whole_split:.3f} s: {split}")
    log(f"phase 13: MSMs cut along N: " + "; ".join(f"M={M} over N={N}: {k_} slices, {c_} call(s)"
                                                  for (M, N, k_), c_ in sorted(cuts.items()))
        + f"; t's size N={sizes['t']} {huge_res['t s']:.3f} s, the helper's N={sizes['helper']} "
        f"{huge_res['helper s']:.3f} s; each equal, affine, to the uncut 2^20-point MSM of its per-point "
        f"summed scalars mod r; peak device memory {huge_path.peak / 2**30:.2f} GiB; kernel launches "
        f"{huge_path.launches}")
    if {N for (_, N, k_) in cuts if k_ > 1} != set(sizes.values()):
        raise AssertionError(f"phase 13: the N-cut did not run on both sizes: {dict(cuts)}")
    k1_checked(huge_path, "phase 13")
    huge_k2 = {}
    for pts, plan in huge_path.sums:  # the first launch of each (M, W, B, N)
        kind = next((k for k, N in sizes.items()
                     if plan.npoints in {b - a for a, b in pippenger._n_slices(N, plan.shape[1])}), None)
        if kind is None or kind + " slice" in huge_k2:
            continue
        err, ms, plain_ms, bound = check_sums(pts, plan, f"phase 13 {kind} slice {plan.shape} (M, W, B) over "
                                                         f"N={plan.npoints}")
        k2_err.append(err)
        huge_k2[kind + " slice"] = (plan.shape, plan.npoints, plan.entries, ms, plain_ms, bound)
    if set(huge_k2) != {"t slice", "helper slice"}:
        raise AssertionError(f"phase 13: kernel 2 was not held on both slices: {sorted(huge_k2)}")
    del huge_path, huge_pts, huge_sc, huge_res, whole_sc, helper_ref, pts, plan
    log(f"phase 13: {time.perf_counter() - t13:.1f} s for the phase")

    # -- phase 14: kernel 4, the openings' division, at the main path's shapes ---------------------
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    k4 = poly_div_phase(dev)
    log(f"phase 14: {time.perf_counter() - t14:.1f} s for the phase")

    def total(kernel):
        return sum(p[kernel] for p in paths.values())

    kernels_line = {"kernels": [
        {"name": "mont_mul", "route": "cuda", "source": "sonic_tpu_torch/csrc/mont_mul.cu",
         "replaces": "sonic_tpu/fields/pallas_mul.py:147", "launches": total("mont_mul"),
         "launches_by_path": {k: v["mont_mul"] for k, v in paths.items()},
         "max_abs_err": max(k1_err), "ms": k1["Fq"][1], "plain_ms": k1["Fq"][2],
         "bound_ms": k1["Fq"][3], "bound_by": "bytes", "library_ms": None},
        {"name": "bucket_sums", "route": "cuda", "source": "sonic_tpu_torch/csrc/bucket_acc.cu",
         "replaces": "sonic_tpu/msm/pallas_acc.py:136", "launches": total("bucket_sums"),
         "launches_by_path": {k: v["bucket_sums"] for k, v in paths.items()},
         "max_abs_err": max(k2_err), "ms": k2_main[0], "plain_ms": k2_main[1],
         "bound_ms": k2_main[2], "bound_by": "operations", "library_ms": None,
         "big": {k: dict(zip(("shape", "npoints", "entries", "ms", "plain_ms", "bound_ms"), v))
                 for k, v in big_k2.items()},
         "huge": {k: dict(zip(("shape", "npoints", "entries", "ms", "plain_ms", "bound_ms"), v))
                  for k, v in huge_k2.items()},
         "big_batch": big_batch_k2},
        {"name": "msm_tail", "route": "cuda", "source": "sonic_tpu_torch/csrc/msm_tail.cu",
         "replaces": None, "plain_of": "sonic_tpu/msm/pippenger.py _bucket_weighted_sum, _window_combine (jnp)",
         "launches": total("msm_tail"), "launches_by_path": {k: v["msm_tail"] for k, v in paths.items()},
         "max_abs_err": max(v["max_abs_err"] for v in k3.values()),
         "ms": k3["window_combine"]["ms"], "plain_ms": k3["window_combine"]["plain_ms"],
         "bound_ms": k3["window_combine"]["chain_ms"], "bound_by": "latency: one row's serial chain",
         "library_ms": None, "entries": k3},
        {"name": "poly_div", "route": "cuda", "source": "sonic_tpu_torch/csrc/poly_div.cu",
         "replaces": None, "plain_of": "sonic_tpu/poly/laurent.py div_by_linear_batched (jnp)",
         "launches": total("poly_div"), "launches_by_path": {k: v["poly_div"] for k, v in paths.items()},
         "max_abs_err": 0, "ms": k4["64x196609"]["ms"], "plain_ms": k4["64x196609"]["plain_ms"],
         "bound_ms": k4["64x196609"]["bound_ms"], "bound_by": "bytes", "library_ms": None, "entries": k4},
    ], "multi_rank_launches": f"summed over the {WORLD} ranks of phase 9"}
    log(f"card: {card}; kernel 1 Fr 2^20+3: {k1['Fr'][1]:.4f} ms (bound {k1['Fr'][3]:.4f}); "
        f"kernel 2 2^16-point MSM: {k2_16_ms:.3f} ms (bound {k2_16_bound:.3f}, plain {k2_16_plain:.3f}); "
        + "".join(f"kernel 3 {k} over {v['rows']} rows: {v['ms']:.3f} ms (one row {v['chain_ms']:.3f}, "
                  f"plain {v['plain_ms']:.1f}); " for k, v in k3.items())
        + f"batch's largest launch: {k2_batch[0]:.3f} ms (bound {k2_batch[2]:.3f}, plain {k2_batch[1]:.3f}); "
        + "; ".join(f"big {k} {v[0]} over N={v[1]}, E={v[2]}: {v[3]:.3f} ms (bound {v[5]:.3f}, plain "
                    f"{'not timed; held on its last MSM row' if v[4] is None else f'{v[4]:.3f}'})" for k, v in big_k2.items()))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
