"""Where one prove spends its time: phase timers and a device profile.

    python -m sonic_tpu_torch.breakdown [--device cuda] [--n 1024] [--q 64]
                                        [--seed 42] [--reps 3] [--profiler]

Sets up what `example.py --n N --q Q` sets up (random_circuit(Random(seed),
n, q), d = 7n + 20, the verifier-mode SRS built on the device), proves once
to warm up and times `reps` proves. Then it proves once more with a
synchronizing timer around each phase function of the prover and prints,
per phase, its seconds, its calls and the kernel-1 launches made inside it.
Rows that start with "in" are nested inside the phases above them. With
--profiler, one more prove runs under torch.profiler, and the device's
events, busy seconds, busy share of the wall and busiest kernels are
printed (on the CPU there are no device events).

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
    (pippenger, "accumulate", "in MSMs: scan (kernel 2)"),
    (pippenger, "_fold_lanes", "in MSMs: lane fold"),
    (pippenger, "_bucket_weighted_sum", "in MSMs: bucket weighted sum"),
    (commitment, "div_by_linear", "in openings: div_by_linear"),
    (commitment, "div_by_linear_batched", "in openings: div_by_linear_batched"),
    (signature, "s_at_y_batched", "in helper: s(X, y_j) build"),
    (signature, "s_at_u_of_y", "in helper: s(u, Y) build"),
]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timers(device: torch.device):
    """Yields {label: [seconds, calls, kernel-1 launches]}, filled by the
    calls made inside the block."""
    acc: dict = collections.defaultdict(lambda: [0.0, 0, 0])
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in PHASES]

    def timer(fn, label):
        def timed(*args, **kwargs):
            _sync(device)
            launches, t0 = mont_mul.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            row = acc[label]
            row[0] += time.perf_counter() - t0
            row[1] += 1
            row[2] += mont_mul.launches - launches
            return out

        return timed

    try:
        for (mod, name, fn), (_, _, label) in zip(saved, PHASES):
            setattr(mod, name, timer(fn, label))
        yield acc
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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
    parser.add_argument("--n", type=int, default=1024, help="gates of the random circuit")
    parser.add_argument("--q", type=int, default=64, help="its linear constraints")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--reps", type=int, default=3, help="timed proves")
    parser.add_argument("--profiler", action="store_true", help="one more prove under torch.profiler")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("breakdown: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    rng = random.Random(args.seed)
    circuit, assignment = random_circuit(rng, n=args.n, q=args.q)
    d = 7 * args.n + 20
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    srs = SRS.new(d, x, alpha, h_mode="verifier", n_hints=[args.n], device=device)
    dc = DeviceCircuit.from_host(circuit, device=device)
    da = DeviceAssignment.from_host(assignment, device=device)
    rnd = gp.Randomness.generate(rng, m=args.q)

    def prove():
        return protocol.prove(srs, da, dc, rnd)

    prove()  # warm-up
    times = []
    for _ in range(args.reps):
        _sync(device)
        t0 = time.perf_counter()
        prove()
        _sync(device)
        times.append(time.perf_counter() - t0)
    print(f"n={args.n} q={args.q} d={d} on {device}: prove s {times} "
          f"median {statistics.median(times)}", flush=True)

    with phase_timers(device) as acc:
        _sync(device)
        t0 = time.perf_counter()
        prove()
        _sync(device)
        wall = time.perf_counter() - t0
    print(f"prove with phase timers: {wall} s", flush=True)
    print(f"  {'phase':40s} {'s':>10s} {'calls':>6s} {'mont_mul launches':>18s}")
    for label in sorted(acc, key=lambda k: (k.startswith("in "), -acc[k][0])):
        s, calls, launches = acc[label]
        print(f"  {label:40s} {s:10.4f} {calls:6d} {launches:18d}", flush=True)

    if args.profiler:
        pwall, nev, busy, rows = device_profile(prove, device)
        share = 100 * busy / pwall
        print(f"prove under torch.profiler: wall {pwall} s; device events {nev}, "
              f"busy {busy} s ({share:.1f} % of wall)", flush=True)
        for name, calls, ms in rows:
            print(f"  {ms:10.3f} ms {calls:7d}x  {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
