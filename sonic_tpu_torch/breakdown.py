"""Where one prove spends its time: phase timers and a device profile.
With BATCH_PHASES, the timers cover `prove_batch` too.

    python -m sonic_tpu_torch.breakdown [--device cuda] [--n 1024] [--q 64]
                                        [--seed 42] [--reps 3] [--batch B]
                                        [--profiler]

Sets up what `example.py --n N --q Q` sets up (random_circuit(Random(seed),
n, q), d = 7n + 20, the verifier-mode SRS built on the device), proves once
to warm up and times `reps` proves. With --batch B, each prove is one
`prove_batch` of B such circuits (one random_circuit each, as bench.py's
batch), timed with PHASES + BATCH_PHASES, and the helper's slices of the
proofs are printed too. Then it proves once more with a
synchronizing timer around each phase function of the prover and prints,
per phase, its seconds, its calls, the kernel-1 launches made inside it
and its peak device memory, and how many slices of the M axis each shape
of batched MSM was cut into (`budget`, `pippenger.slicings`). Rows that start
with "in" are nested inside the phases above them. With
--profiler, one more prove runs under torch.profiler, and the device's
events, busy seconds, busy share of the wall and busiest kernels are
printed (on the CPU there are no device events).

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
import contextlib
import random
import statistics
import sys
import time

import torch

from . import commitment, protocol, signature
from . import golden_protocol as gp
from .circuit import random_circuit
from .constraints import DeviceAssignment, DeviceCircuit
from .fields import mont_mul
from .msm import pippenger
from .parallel import distributed, ntt_sharded
from .parallel import mesh as pmesh
from .srs import SRS

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
    `helper` prove_batch's calls by (B, the helper's slices of the proofs),
    and `peak` is the most device memory allocated at any time inside the
    block since the allocator's peak was last reset before it (0 on the
    CPU)."""

    def __init__(self):
        super().__init__(lambda: [0.0, 0, 0, 0])
        self.peak = 0
        self.slices: collections.Counter = collections.Counter()
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
    before = collections.Counter(pippenger.slicings)
    helper_before = collections.Counter(protocol.helper_slicings)
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
        acc.slices.update(pippenger.slicings - before)
        acc.helper.update(protocol.helper_slicings - helper_before)


def phase_table(acc: Timings) -> list:
    """The rows of `phase_timers`' table, phases first, longest first, then
    the batched MSMs' slice counts."""
    lines = [f"  {'phase':40s} {'s':>10s} {'calls':>6s} {'mont_mul launches':>18s} {'peak GiB':>9s}"]
    for label in sorted(acc, key=lambda k: (k.startswith("in "), -acc[k][0])):
        s, calls, launches, peak = acc[label]
        lines.append(f"  {label:40s} {s:10.4f} {calls:6d} {launches:18d} {peak / 2**30:9.2f}")
    for (M, N, k), calls in sorted(acc.slices.items()):
        lines.append(f"  batched MSM M={M} over N={N}: {k} slice(s) of M, {calls} call(s)")
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
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("breakdown: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    rng = random.Random(args.seed)
    pairs = [random_circuit(rng, n=args.n, q=args.q) for _ in range(max(1, args.batch))]
    d = 7 * args.n + 20
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    with distributed.launched_mesh() as mesh:
        # with a mesh, every rank runs everything and rank 0 reports
        say = print if mesh is None or mesh.get_local_rank() == 0 else (lambda *a, **k: None)
        srs = SRS.new(d, x, alpha, h_mode="verifier", n_hints=[args.n], device=device, mesh=mesh)
        dcs = [DeviceCircuit.from_host(c, device=device) for c, _ in pairs]
        das = [DeviceAssignment.from_host(a, device=device) for _, a in pairs]
        rnds = [gp.Randomness.generate(rng, m=args.q) for _ in pairs]
        phases = PHASES + (BATCH_PHASES if args.batch else [])

        def prove():
            if args.batch:
                return protocol.prove_batch(srs, das, dcs, rnds, mesh=mesh)
            return protocol.prove(srs, das[0], dcs[0], rnds[0], mesh=mesh)

        prove()  # warm-up
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(args.reps):
            _sync(device)
            t0 = time.perf_counter()
            prove()
            _sync(device)
            times.append(time.perf_counter() - t0)
        ranks = f", {mesh.size()} ranks" if mesh is not None else ""
        peak = (f", peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if device.type == "cuda" else "")
        what = f"prove_batch of {args.batch}" if args.batch else "prove"
        say(f"n={args.n} q={args.q} d={d} on {device}{ranks}: {what} s {times} "
            f"median {statistics.median(times)}{peak}", flush=True)

        with phase_timers(device, phases + (PARALLEL_PHASES if mesh is not None else [])) as acc:
            _sync(device)
            t0 = time.perf_counter()
            prove()
            _sync(device)
            wall = time.perf_counter() - t0
        say(f"{what} with phase timers: {wall} s", flush=True)
        say("\n".join(phase_table(acc)), flush=True)

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
