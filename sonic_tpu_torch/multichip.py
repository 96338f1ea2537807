"""Several cards, one rank a card: every sharded path held, byte for byte,
against the same call on one card.

Port of the JAX package's multichip dry run (`__graft_entry__.py`,
`dryrun_multichip` / `_dryrun_impl`: a sharded prove compared with the
unsharded one), run at the sizes of BASELINE configs 3 and 4:

    python -m torch.distributed.run --standalone --nproc_per_node=K \\
        -m sonic_tpu_torch.multichip [--device cpu] [--gates N ... --q Q ...]

Every rank calls `distributed.initialize()` and `global_mesh()`, then runs
each path below with `mesh=` on the same inputs, made from fixed seeds:
once to warm up, then `--reps` timed calls (with `--reps 0`, the one call
is the timed one) under `breakdown.PARALLEL_PHASES`' collective timers.
Rank 0 then makes the same call with `mesh=None` and compares:

  srs    SRS.new(h_mode="full") at each --srs-d (trapdoor from
         Random(6)) and at d = 7 n + 20 of the largest prove circuit
         (its trapdoor, as phase 10 of chip_smoke.py draws it); the four
         tables' `table_digest`. The last one is the SRS of the paths
         below; with --prove-srs verifier it is built in verifier mode
         (h_mode="verifier", n_hints the proves' n: the G1 tables and
         the few G2 rows pcV reads, as bench.py's big path and
         `breakdown` prove), and its digest is the G1 tables';
  prove  prove on random_circuit(Random(seed), n, q) for each --gates,
         --q, --seeds; proof bytes (`serial.proof_to_bytes`), then rank 0's
         sharded proof verifies True and False once tampered;
  ntt    parallel/ntt_sharded.poly_mul_ntt_sharded against
         poly/ntt.poly_mul_ntt at transform 2^k for each --ntt k, two
         inputs of 2^(k-1) random canonical coefficients (numpy seed 3);
         the same Montgomery integers;
  batch  prove_batch of --batch random_circuit(Random(7), --batch-gates,
         --batch-q) (chip_smoke.py phase 7's circuits); every proof's bytes.

Every rank's result is compared (its sha256 gathered to rank 0), and a
broadcast verdict makes every rank fail together on a mismatch. Rank 0
prints one JSON line a path and size: K, its sharded seconds (median and
min) and every rank's, the single-card seconds of the same process and
that call's peak device memory, the collectives' seconds and calls a
call, each rank's peak device memory (`max_memory_allocated`) and
kernel-1 / kernel-2 launches a call, the four-step products a call
(all_to_all_single calls / 3), and the cards' `nvidia-smi` name and
power limit. The last line is
{"ok": true, "n_devices": K, "backend": "nccl", ...}.

BASELINE config 4 at its own size (an n = 2^20, q = 64 circuit, d =
7,340,052), a rank a card:

    python -m torch.distributed.run --standalone --nproc_per_node=K \\
        -m sonic_tpu_torch.multichip --srs-d --gates 1048576 --q 64 \\
        --seeds 20 --ntt --batch 0 --reps 1 --prove-srs verifier

No fallback: on CUDA the group is NCCL, one card a rank (`initialize`
refuses a world larger than the card count), a size that does not
four-step split over the ranks raises, and a failed path ends the run.
`--device cpu` (gloo) is for the tests.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import breakdown, protocol, serial
from . import golden_protocol as gp
from .circuit import random_circuit
from .constraints import DeviceAssignment, DeviceCircuit
from .fields import mont_mul
from .fields.limb import FR
from .msm import bucket_acc
from .parallel import distributed, ntt_sharded
from .poly import ntt
from .srs import SRS

SRS_SEED, NTT_SEED, BATCH_SEED = 6, 3, 7  # chip_smoke.py phase 6's trapdoor, bench.py's _bench_ntt, phase 7


def table_digest(srs, names=("g_x", "g_ax", "h_x", "h_ax")) -> str:
    """sha256 of a device SRS's tables: x, y limbs and infinity flags."""
    h = hashlib.sha256()
    for name in names:
        for a in getattr(srs, name):
            h.update(a.cpu().numpy().tobytes())
    return h.hexdigest()


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _proof_digest(proof) -> str:
    return _sha(serial.proof_to_bytes(proof))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cards(dev: torch.device) -> list:
    """`nvidia-smi`'s name and power limit of each card (none on the CPU)."""
    if dev.type != "cuda":
        return []
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()


def _random_coeffs(count: int, seed: int, device) -> torch.Tensor:
    """(count, 16) random canonical Fr limbs from numpy's generator `seed`
    (16-bit limbs; the top one below the modulus's top limb)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(count, FR.nlimbs), dtype=np.int64)
    a[:, -1] = rng.integers(0, FR.mod_limbs[-1], size=count, dtype=np.int64)
    return torch.from_numpy(a).to(device)


class Run:
    """One rank's state: its mesh, device and what rank 0 prints."""

    def __init__(self, mesh, dev: torch.device, reps: int):
        self.mesh, self.dev, self.reps = mesh, dev, reps
        self.rank, self.K = mesh.get_local_rank(), mesh.size()
        self.cards = _cards(dev) if self.rank == 0 else []

    def say(self, obj) -> None:
        if self.rank == 0:
            print(json.dumps(obj), flush=True)

    def measure(self, fn):
        """fn once to warm up (when reps > 0), then `reps` timed calls (or
        the one call) under the collective timers. Returns the last call's
        result and its record: seconds, collectives a call, peak device
        bytes and kernel launches a call."""
        if self.reps:
            fn()
        calls = max(self.reps, 1)
        cuda = self.dev.type == "cuda"
        _sync(self.dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        k1, k2 = mont_mul.launches, bucket_acc.launches
        times, out = [], None
        with breakdown.phase_timers(self.dev, breakdown.PARALLEL_PHASES) as acc:
            for _ in range(calls):
                out = None  # the last result goes before the next call
                _sync(self.dev)
                t0 = time.perf_counter()
                out = fn()
                _sync(self.dev)
                times.append(time.perf_counter() - t0)
        rec = {
            "s": times,
            "collectives": {k: [v[0] / calls, v[1] / calls] for k, v in acc.items()},
            "peak_gib": acc.peak / 2**30,
            "launches": {"mont_mul": (mont_mul.launches - k1) / calls,
                         "bucket_sums": (bucket_acc.launches - k2) / calls},
        }
        return out, rec

    def verdict(self, fails: list) -> None:
        """Rank 0's failures, broadcast: every rank raises together."""
        flag = torch.tensor([len(fails)], dtype=torch.int64,
                            device=self.dev if self.dev.type == "cuda" else "cpu")
        dist.broadcast(flag, src=0, group=self.mesh.get_group())
        if int(flag):
            raise RuntimeError("multichip: " + ("; ".join(fails) if fails else
                                                f"rank 0 found {int(flag)} mismatch(es)"))

    def path(self, name: str, size: dict, sharded, single, digest, check=None):
        """One path at one size: the sharded call on every rank, each rank's
        digest gathered, rank 0's single-card call, the comparison (and
        `check(sharded result)`'s failures on rank 0), the verdict and
        rank 0's line. Returns the sharded result."""
        out, rec = self.measure(sharded)
        rec["digest"] = digest(out)
        recs = [None] * self.K
        dist.all_gather_object(recs, rec, group=self.mesh.get_group())
        fails, line = [], None
        if self.rank == 0:
            _sync(self.dev)
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.dev)
            t0 = time.perf_counter()
            ref = single()
            _sync(self.dev)
            t_single = time.perf_counter() - t0
            single_peak = (torch.cuda.max_memory_allocated(self.dev) / 2**30
                           if self.dev.type == "cuda" else 0.0)
            want = digest(ref)
            del ref
            fails = [f"{name} {size}: rank {r}'s sharded result differs from the single card's"
                     for r, x in enumerate(recs) if x["digest"] != want]
            extra = check(out) if check else {}
            fails += extra.pop("fails", [])
            s = rec["s"]
            line = {"path": name, **size, "K": self.K, "sharded_s": s, "median_s": statistics.median(s),
                    "min_s": min(s),
                    "ranks_median_min_s": [[statistics.median(x["s"]), min(x["s"])] for x in recs],
                    "single_s": t_single, "single_peak_gib": single_peak,
                    "collectives": rec["collectives"],
                    "four_step_products": rec["collectives"].get(
                        "in comms: all_to_all_single (NTT)", [0, 0])[1] / 3,
                    "peak_gib": [x["peak_gib"] for x in recs],
                    "launches": [x["launches"] for x in recs],
                    "digest": want if isinstance(want, str) else _sha("".join(want).encode()),
                    "equal": not fails, **extra, "cards": self.cards}
        self.verdict(fails)
        self.say(line)
        return out


def _host_inputs(n: int, q: int, seed: int):
    """random_circuit(Random(seed), n, q), the trapdoor (x, alpha) drawn
    after it and then its Randomness, as chip_smoke.py phases 5 and 10
    draw theirs."""
    rng = random.Random(seed)
    circuit, assignment = random_circuit(rng, n=n, q=q)
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    return circuit, assignment, x, alpha, gp.Randomness.generate(rng, m=q)


def run_paths(run: Run, args) -> None:
    dev, mesh = run.dev, run.mesh
    proves = [(n, q, seed, _host_inputs(n, q, seed)) for n, q, seed in
              sorted(zip(args.gates, args.q, args.seeds), key=lambda c: c[0])]
    big_n, _, _, (_, _, big_x, big_alpha, _) = proves[-1]

    # 1. srs: the last one stays, for the proves and the batch
    srng = random.Random(SRS_SEED)
    sx, salpha = srng.randrange(2, gp.P), srng.randrange(2, gp.P)
    srs = None
    hints = sorted({n for n, _, _, _ in proves})
    for d, x, alpha, mode in ([(d, sx, salpha, "full") for d in args.srs_d]
                              + [(7 * big_n + 20, big_x, big_alpha, args.prove_srs)]):
        srs = None
        kw = dict(h_mode=mode, device=dev) | ({"n_hints": hints} if mode == "verifier" else {})
        tables = ("g_x", "g_ax") if mode == "verifier" else ("g_x", "g_ax", "h_x", "h_ax")
        srs = run.path("srs", {"d": d, "h_mode": mode},
                       lambda: SRS.new(d, x, alpha, mesh=mesh, **kw),
                       lambda: SRS.new(d, x, alpha, **kw), lambda t: table_digest(t, tables))

    # 2. prove
    for n, q, seed, (circuit, assignment, _, _, rnd) in proves:
        dc = DeviceCircuit.from_host(circuit, device=dev)
        da = DeviceAssignment.from_host(assignment, device=dev)

        def check(res):
            proof, oracle = res
            ok = protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
            bad = dataclasses.replace(proof, pr_a=(proof.pr_a + 1) % gp.P)
            tampered = protocol.verify(srs, dc, bad, oracle.y, oracle.z, oracle.yzs)
            return {"verify": ok, "tampered_verify": tampered,
                    "fails": ([] if ok else [f"prove n={n}: verify returned False"])
                    + ([f"prove n={n}: a tampered proof verified"] if tampered else [])}

        run.path("prove", {"n": n, "q": q, "seed": seed, "d": srs.d},
                 lambda: protocol.prove(srs, da, dc, rnd, mesh=mesh),
                 lambda: protocol.prove(srs, da, dc, rnd), lambda res: _proof_digest(res[0]), check)
        del dc, da
    del proves

    # 3. ntt: the four-step product
    for k in args.ntt:
        half = 1 << (k - 1)
        a, b = _random_coeffs(2 * half, NTT_SEED, dev).split(half)
        run.path("ntt", {"transform": 1 << k, "inputs": half},
                 lambda: ntt_sharded.poly_mul_ntt_sharded(a, b, mesh),
                 lambda: ntt.poly_mul_ntt(a, b), lambda t: _sha(t.cpu().numpy().tobytes()))
        del a, b

    # 4. batch
    if args.batch:
        brng = random.Random(BATCH_SEED)
        bpairs = [random_circuit(brng, n=args.batch_gates, q=args.batch_q) for _ in range(args.batch)]
        brnds = [gp.Randomness.generate(brng, m=args.batch_q) for _ in range(args.batch)]
        dcs = [DeviceCircuit.from_host(c, device=dev) for c, _ in bpairs]
        das = [DeviceAssignment.from_host(a, device=dev) for _, a in bpairs]
        del bpairs
        run.path("batch", {"B": args.batch, "n": args.batch_gates, "q": args.batch_q, "d": srs.d},
                 lambda: protocol.prove_batch(srs, das, dcs, brnds, mesh=mesh),
                 lambda: protocol.prove_batch(srs, das, dcs, brnds),
                 lambda res: [_proof_digest(p) for p, _ in res])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="cuda (NCCL, a card a rank) or cpu (gloo, tests)")
    parser.add_argument("--srs-d", type=int, nargs="*", default=[1 << 16],
                        help="degrees of the full SRS path besides the proves' 7 n + 20")
    # --gates: torch.distributed.run rejects --n as an ambiguous abbreviation of its own options
    parser.add_argument("--gates", type=int, nargs="+", default=[1024, 1 << 16], help="gates of each prove's circuit")
    parser.add_argument("--q", type=int, nargs="+", default=[64, 64], help="their linear constraints")
    parser.add_argument("--seeds", type=int, nargs="+", default=[42, 77],
                        help="their random_circuit seeds (chip_smoke.py phases 5 and 10)")
    parser.add_argument("--ntt", type=int, nargs="*", default=[20, 23], help="log2 of each product's transform")
    parser.add_argument("--batch", type=int, default=64, help="circuits of the prove_batch path (0: none)")
    parser.add_argument("--batch-gates", type=int, default=1024)
    parser.add_argument("--batch-q", type=int, default=8)
    parser.add_argument("--reps", type=int, default=2, help="timed sharded calls after the warm-up")
    parser.add_argument("--prove-srs", choices=("full", "verifier"), default="full",
                        help="the mode of the SRS the proves and the batch run on")
    args = parser.parse_args(argv)
    if not len(args.gates) == len(args.q) == len(args.seeds):
        parser.error("--gates, --q and --seeds need one value per prove")

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("multichip: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if "WORLD_SIZE" not in os.environ:
        print("multichip: run it under python -m torch.distributed.run --nproc_per_node=K", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    distributed.initialize(backend="nccl" if cuda else "gloo", init_method="env://")
    try:
        backend = dist.get_backend()
        if cuda and backend != "nccl":
            raise RuntimeError(f"multichip: backend {backend}; the card path runs over NCCL only")
        mesh = distributed.global_mesh()
        if cuda:
            dev = torch.device("cuda", torch.cuda.current_device())
        run = Run(mesh, dev, args.reps)
        builds = None
        if cuda:  # every rank builds at once: one library, under the build's lock
            from . import kernels, native

            t0 = time.perf_counter()
            so = os.path.basename(kernels.build())
            native.get_lib()
            builds = [None] * run.K
            dist.all_gather_object(builds, [so, time.perf_counter() - t0], group=mesh.get_group())
            if len({b[0] for b in builds}) != 1:
                raise RuntimeError(f"multichip: the ranks loaded different kernel libraries {builds}")
        run_paths(run, args)
        run.say({"ok": True, "n_devices": run.K, "backend": backend,
                 "device": torch.cuda.get_device_name(dev) if cuda else "cpu", "cards": run.cards,
                 "builds": builds, "seconds": time.perf_counter() - t_start})
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
