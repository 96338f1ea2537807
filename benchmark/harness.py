"""One run of one cell: set-up, the measured window, the check of every
proof the window made against the plain reference, and the result.

Set-up makes the cell's inputs from the seed (the configuration's
circuit family and `gen`), builds the SRS on the device from the seed's
trapdoor (`SRS.new`, in the configuration's mode), uploads the circuits
and the witness pool (the family's upload, or `upload_dense`), and makes
one warm-up call of each kind the traffic uses. The window is a closed
loop of one client: a call starts while less than `seconds` have passed
since the window opened, and every call runs whole. Each request takes
the next witness of the pool and fresh randomness; nothing but the
circuits' weights and the SRS is kept from one request to the next.

With trace, the window's first call runs under the profiler (no timers)
and the others under the synchronising timers and counters the cell's
per-layer metrics name; the result then holds those metrics.

After the window, the device state is freed and every proof is worked
out again by `reference` (in worker processes) and compared element by
element; every `verify` the traffic makes must say True. Each number
compared goes out beside its limit, on standard error and last in the
result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch import protocol
from sonic_tpu_torch.circuit import ArithCircuit, Assignment, GateWeights
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.fields.limb import FR
from sonic_tpu_torch.srs import SRS

from . import gen, reference, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sonic_tpu")


@dataclasses.dataclass
class Spec:
    """A cell as BENCHMARK.json and its files give it."""

    cell: dict
    config: dict
    traffic: dict
    end_to_end: list  # metric entries that apply to the cell
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_spec(workload: str, root: str = ROOT) -> Spec:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Spec(cell, config, traffic, [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def load_metric(name: str):
    """benchmark/metrics/<name>.py: `read(run)` and what it needs traced."""
    return gen.load(os.path.join(HERE, "metrics", name + ".py"), f"benchmark_metric_{name}")


def flatten(proof) -> list:
    """A program's Proof -> its elements in `reference.names` order."""
    h = proof.pr_hsc
    out = [proof.pr_r, proof.pr_t, proof.pr_a, proof.pr_wa, proof.pr_b, proof.pr_wb, proof.pr_wt,
           proof.pr_s]
    for cm, (s, w) in h.hsc_s:
        out += [cm, s, w]
    for s2, w2, qj in h.hsc_w:
        out += [s2, w2, qj]
    out += [h.hsc_qv, h.hsc_c, h.hsc_u, h.hsc_v]
    return [None if e is None else (int(e) if isinstance(e, int) else tuple(int(c) for c in e))
            for e in out]


@dataclasses.dataclass
class Call:
    kind: str  # "prove", "prove_batch" or "verify"
    seconds: float
    proofs: int


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    calls: list  # Call, the window's untraced calls
    span_s: dict = dataclasses.field(default_factory=dict)  # (module, attr) -> seconds
    counters: dict = dataclasses.field(default_factory=dict)  # (module, attr) -> increase
    proofs_timed: int = 0  # proofs of the calls under the timers
    profile: object = None  # trace.Profile of the profiled call
    hooks: dict = dataclasses.field(default_factory=dict)  # (module, attr) -> total in it
    busy_s: float | None = None  # the profiled call's, averaged over the ranks
    window_s: float | None = None

    def per_proof(self, keys) -> float | None:
        if not self.proofs_timed:
            return None
        return sum(self.span_s.get(tuple(k), 0.0) for k in keys) / self.proofs_timed


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _timed(fn, device):
    trace.sync(device)
    t0 = time.perf_counter()
    out = fn()
    trace.sync(device)
    return out, time.perf_counter() - t0


def upload_dense(rows: tuple, witnesses: list, config: dict, device) -> list:
    """The default upload: the circuit's rows as dense (Q, n) matrices,
    int64 where every weight is below 2^63, through `DeviceCircuit.from_host`,
    and one DeviceCircuit a witness that differs only in its cs."""
    mats = []
    for r in rows:
        small = bool((r.vals < 2**63).all())
        m = np.zeros((r.q, r.n), np.int64 if small else object)
        m[np.repeat(np.arange(r.q), np.diff(r.indptr)), r.cols] = r.vals.astype(np.int64) if small else r.vals
        mats.append(m)
    dc = DeviceCircuit.from_host(ArithCircuit(GateWeights(*mats), witnesses[0].cs), device=device)
    return [dataclasses.replace(dc, cs=FR.from_int(w.cs, device=device)) for w in witnesses]


def load_upload(config: dict):
    """`upload(rows, witnesses, config, device)` of the configuration's
    circuit family: `<name>.upload.py` beside the family's file where there
    is one (it may import the port), `upload_dense` where there is none."""
    name = gen.circuit_name(config)
    path = os.path.join(gen.CIRCUITS, name + ".upload.py")
    if not os.path.exists(path):
        return upload_dense
    return gen.load(path, f"benchmark_circuit_{name}_upload").upload


class Cell:
    """The cell's inputs, on the device, made from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, mesh=None):
        self.seed, self.device, self.mesh = seed, torch.device(device), mesh
        self.config, self.d = config, config["d"]
        self.n, self.m = config["gates"], gen.helper_instances(config)
        self.batch = config.get("batch", 1)
        self.kind, self.verify, self.pool = traffic["call"], traffic["verify"], traffic["witness_pool"]
        if (self.kind == "prove") != (self.batch == 1):
            raise ValueError(f"traffic {self.kind!r} with {self.batch} circuits a call")
        x, alpha = gen.trapdoor(seed)
        self.srs = SRS.new(self.d, x, alpha, h_mode=config["srs_mode"], n_hints=[self.n],
                           device=self.device, mesh=mesh)
        fam, upload = gen.family(config), load_upload(config)
        self.dcs, self.das = [], []
        for c in range(self.batch):
            rows = fam.rows(seed, c, config)
            wits = [fam.witness(seed, c, k, config, rows) for k in range(self.pool)]
            self.dcs.append(upload(rows, wits, config, self.device))
            self.das.append([DeviceAssignment.from_host(Assignment(wt.aL, wt.aR, wt.aO),
                                                        device=self.device) for wt in wits])

    def jobs(self, what: str, k: int) -> list:
        """Request k's proofs: [(circuit, witness, gen.Rnd)]."""
        return [(c, k % self.pool, gen.randomness(self.seed, what, k * self.batch + c, self.m))
                for c in range(self.batch)]

    def prove(self, jobs: list, to_program) -> list:
        rnds = [to_program(gp.Randomness(r.cns, r.y, r.z, r.ys, r.zs, r.u, r.v)) for _, _, r in jobs]
        if self.kind == "prove":
            c, k, _ = jobs[0]
            return [protocol.prove(self.srs, self.das[c][k], self.dcs[c][k], rnds[0], mesh=self.mesh)]
        return protocol.prove_batch(self.srs, [self.das[c][k] for c, k, _ in jobs],
                                    [self.dcs[c][k] for c, k, _ in jobs], rnds, mesh=self.mesh)

    def check(self, jobs: list, outs: list) -> list:
        """`verify` of each proof, on the device's recompute and the host's pairings."""
        return [protocol.verify(self.srs, self.dcs[c][k], proof, o.y, o.z, o.yzs)
                for (c, k, _), (proof, o) in zip(jobs, outs)]

    def free(self) -> None:
        self.srs = self.dcs = self.das = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _go(flag: bool, mesh, device) -> bool:
    """Rank 0's decision, on every rank."""
    if mesh is None:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def _gather(obj, mesh) -> list:
    if mesh is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def device_info(device, chips: int) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(smi.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(spec: Spec, seed: int, seconds: float, trace_on: bool, device="cuda", mesh=None,
             t0: float | None = None, workers: int | None = None, to_program=lambda r: r) -> dict | None:
    """One run of the cell; returns the result dict on rank 0 (None on
    the other ranks). `to_program` may change the randomness the program
    is given (the control); the reference always gets the request's."""
    t0 = time.time() if t0 is None else t0
    device = torch.device(device)
    rank0 = mesh is None or mesh.get_local_rank() == 0
    readers = {m["name"]: load_metric(m["name"]) for m in (spec.per_layer if trace_on else spec.end_to_end)}
    span_keys = [k for r in readers.values() for k in getattr(r, "SPANS", ())]
    counter_keys = [k for r in readers.values() for k in getattr(r, "COUNTERS", ())]
    hooks = trace.Hooks({k: f for r in readers.values() for k, f in getattr(r, "HOOKS", {}).items()})
    spans = trace.Spans(span_keys, device)

    cell = Cell(spec.config, spec.traffic, seed, device, mesh)
    warm = cell.jobs("warmup", 0)
    outs = cell.prove(warm, to_program)
    if cell.verify:
        cell.check(warm, outs)
    trace.sync(device)
    del outs
    run = Run(setup_s=time.time() - t0, calls=[])
    log(f"set-up {run.setup_s:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    made = []  # (jobs, outputs, verify answers)
    counted = dict.fromkeys(map(tuple, counter_keys), 0)
    opened = time.perf_counter()
    k, timed_calls = 0, 0
    while _go(k == 0 or time.perf_counter() - opened < seconds or (trace_on and timed_calls == 0),
              mesh, device):
        jobs = cell.jobs("window", k)
        if trace_on and k == 0:
            t_prof = time.perf_counter()
            with hooks.on():
                outs, run.profile = trace.profile_call(lambda: cell.prove(jobs, to_program), device,
                                                       span_keys)
            log(f"profiled call {run.profile.window_s:.3f} s ({time.perf_counter() - t_prof:.3f} s with "
                f"the profiler's reduction), busy {run.profile.busy_s:.3f} s, "
                f"{run.profile.events} device events")
        elif trace_on:
            before = trace.read_counters(counted)
            with spans.on():
                outs, _ = _timed(lambda: cell.prove(jobs, to_program), device)
            for key, v in trace.read_counters(counted).items():
                counted[key] += v - before[key]
            run.proofs_timed += len(jobs)
            timed_calls += 1
        else:
            outs, s = _timed(lambda: cell.prove(jobs, to_program), device)
            run.calls.append(Call(cell.kind, s, len(jobs)))
        answers = []
        if cell.verify:
            answers, s = _timed(lambda: cell.check(jobs, outs), device)
            run.calls.append(Call("verify", s, len(jobs)))
        made.append((jobs, [flatten(p) for p, _ in outs], answers))
        k += 1
    trace.sync(device)
    log(f"window {time.perf_counter() - opened:.3f} s, {k} calls")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run.span_s, run.counters, run.hooks = dict(spans.seconds), counted, dict(hooks.totals)
    cell.free()

    prof = run.profile
    shared = _gather({"made": [m[1] for m in made], "peak": peak,
                      "busy": prof.busy_s if prof else None, "window": prof.window_s if prof else None},
                     mesh)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"these modules are loaded once the window has closed: {bad}")
    if not rank0:
        return None
    if prof is not None:
        run.busy_s = sum(s["busy"] for s in shared) / len(shared)
        run.window_s = sum(s["window"] for s in shared) / len(shared)

    jobs = [j for m in made for j in m[0]]
    t_ref = time.perf_counter()
    want = reference.expected(seed, cell.config, jobs, workers or max(
        1, min(len(jobs), (os.cpu_count() or 2) - 1)))
    log(f"reference {time.perf_counter() - t_ref:.3f} s for {len(jobs)} proofs")
    size = len(reference.names(cell.m))
    mismatched = missing = 0
    failed = set()  # indices of the proofs that are wrong on some rank, missing or refused
    for s in shared:
        got = [p for proofs in s["made"] for p in proofs]
        missing += abs(len(got) - len(want))
        failed.update(range(len(got), len(want)))
        for i, (have, exp) in enumerate(zip(got, want)):
            bad_here = sum(a != b for a, b in zip(have, exp)) + abs(len(have) - size)
            mismatched += bad_here
            if bad_here:
                failed.add(i)
    answers = [a for mm in made for a in mm[2]]
    failed.update(i for i, a in enumerate(answers) if a is not True)
    checks = {"mismatched_elements": {"value": mismatched, "limit": 0},
              "missing_proofs": {"value": missing, "limit": 0}}
    if cell.verify:
        checks["verify_false"] = {"value": sum(a is not True for a in answers), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for entry in (spec.per_layer if trace_on else spec.end_to_end):
        value = readers[entry["name"]].read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = device_info(device, spec.cell["chips"])
    dev["memory_peak_bytes"] = max(s["peak"] for s in shared)
    result = {"correct": correct, "attempted": len(jobs), "failed": len(failed), "metrics": metrics,
              "device": dev}
    if trace_on:
        dev["busy_s"], dev["window_s"] = run.busy_s, run.window_s
        if prof is not None:
            top = sorted(prof.kernel_s.items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(prof.idle_s.items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [list(t) for t in top], "idle_gaps": [list(t) for t in gaps]}
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The check lines last on standard error, the result last on standard output."""
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
