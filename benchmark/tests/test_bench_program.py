"""The readings of the program's own spans and counters: the profile's
reduction with the program's events among the harness's labels, each new
reader on synthetic profiles and counters, the collective spans' order on
two gloo ranks, no live span in a run with --trace 0, and a traced run
that reads the new metrics, or leaves them out where the program has no
spans. Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import harness, program, trace  # noqa: E402

TINY = {"gates": 2, "linear_constraints": 1, "d": 34}
SEED = 2**31 + 1201
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class _Event:
    """What `reduce_events` reads of a kineto event."""

    def __init__(self, name, start, end, device=CPU, annotation=True):
        self._n, self._s, self._d, self._dev, self._a = name, start, end - start, device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


def _kernel(name, start, end):
    return _Event(name, start, end, CUDA, annotation=False)


BASE = [
    _Event(trace.WINDOW, 0, 1000),
    _Event("protocol.combine_windows", 100, 600),
    _Event("pippenger.bucket_sums", 700, 800),
    _kernel("bucket_scan_kernel", 150, 200),
    _kernel("mont_mul_kernel", 300, 350),
    _kernel("bucket_scan_kernel", 700, 790),
]
PROGRAM = [
    _Event("sonic.prove", 1, 999),
    _Event("sonic.msm.combine", 100, 600),
    _Event("sonic.msm.bucket_sums", 700, 800),
    _Event("sonic.poly.div", 800, 950),
    _Event("sonic.poly.build", 1, 1000, CUDA),  # a device-side annotation: skipped, as the harness's are
]


def test_the_programs_events_nest_in_the_harness_labels_and_take_their_gaps():
    plain = trace.reduce_events(BASE, 1e-6)
    both = trace.reduce_events(BASE + PROGRAM, 1e-6)
    for field in ("window_s", "busy_s", "kernel_s", "events"):
        assert getattr(both, field) == getattr(plain, field), field
    assert sum(both.idle_s.values()) == pytest.approx(sum(plain.idle_s.values()))
    # each gap goes to the innermost span open at its start: [0, 150) before
    # any; [200, 300) and [350, 700) in sonic.msm.combine (inside the label
    # protocol.combine_windows); [790, 1000) in sonic.msm.bucket_sums
    assert both.idle_s == {"outside the named functions": pytest.approx(150e-9),
                           "sonic.msm.combine": pytest.approx(450e-9),
                           "sonic.msm.bucket_sums": pytest.approx(210e-9)}


def _run(profile=None, hooks=None, counters=None, timed=0):
    return harness.Run(setup_s=0.0, calls=[], profile=profile, hooks=hooks or {}, counters=counters or {},
                       proofs_timed=timed)


def _reader(name):
    return harness.load_metric(name)


@pytest.mark.parametrize("kind", ["single", "batch"])
def test_the_idle_readers_sum_their_layers_gaps_a_proof(kind):
    msm, poly = _reader(f"msm_idle_s.{kind}"), _reader(f"poly_idle_s.{kind}")
    key = next(iter(msm.HOOKS))
    assert key == next(iter(poly.HOOKS)) and key[1] == ("prove" if kind == "single" else "prove_batch")
    idle = {"sonic.msm.combine": 2.0, "sonic.msm.plan": 0.5, "sonic.poly.div": 1.0, "sonic.prove": 0.25,
            program.POLY_LABELS[0]: 0.125, program.POLY_LABELS[1]: 0.0625, "outside the named functions": 0.5}
    run = _run(trace.Profile(10.0, 6.0, {}, idle, 0), {key: 4})
    assert msm.read(run) == pytest.approx(2.5 / 4)
    assert poly.read(run) == pytest.approx((1.0 + 0.125 + 0.0625) / 4)
    parent = _run(trace.Profile(10.0, 6.0, {}, {"protocol.combine_windows": 2.0}, 0), {key: 4})
    assert msm.read(parent) is None and poly.read(parent) is None  # a program without spans
    assert msm.read(_run(None, {key: 4})) is None


@pytest.mark.parametrize("kind", ["single", "batch"])
def test_bucket_adds_reads_the_entries_counter(kind, monkeypatch):
    mod = harness.load_metric(f"bucket_adds.{kind}")
    assert mod.COUNTERS == [mod.KEY]
    assert mod.read(_run(counters={mod.KEY: 900}, timed=3)) == 300
    from sonic_tpu_torch.msm import bucket_acc

    monkeypatch.delattr(bucket_acc, "entries")  # a program without the counter
    mod = harness.load_metric(f"bucket_adds.{kind}")
    assert mod.COUNTERS == [] and mod.read(_run(timed=3)) is None


def _names_rank(rank, world, init, out):
    torch.set_num_threads(1)
    os.environ["SONIC_TPU_NTT_THRESHOLD"] = "64"  # the sharded product's all_to_all too
    from benchmark import gen
    from sonic_tpu_torch import golden_protocol as gp
    from sonic_tpu_torch import protocol
    from sonic_tpu_torch.parallel import distributed
    from sonic_tpu_torch.utils import trace as ptrace

    distributed.initialize(backend="gloo", init_method=init, world_size=world, rank=rank)
    mesh = distributed.global_mesh()
    cell = harness.Cell(dict(TINY, srs_mode="verifier"), {"call": "prove", "verify": False, "witness_pool": 1},
                        SEED, "cpu", mesh)
    r = gen.randomness(SEED, "window", 0, TINY["linear_constraints"])
    with ptrace.recording() as records:
        protocol.prove(cell.srs, cell.das[0][0], cell.dcs[0][0],
                       gp.Randomness(r.cns, r.y, r.z, r.ys, r.zs, r.u, r.v), mesh=mesh)
    with open(f"{out}.{rank}", "w") as f:
        json.dump([(x.name, x.attrs.get("bytes")) for x in records if x.name.startswith("sonic.comm.")], f)
    torch.distributed.destroy_process_group()


def test_two_gloo_ranks_make_the_same_collectives_in_the_same_order(tmp_path):
    out = str(tmp_path / "names")
    torch.multiprocessing.start_processes(_names_rank, args=(2, f"file://{tmp_path}/init", out), nprocs=2,
                                          start_method="spawn")
    ranks = [json.load(open(f"{out}.{r}")) for r in range(2)]
    assert ranks[0] == ranks[1]
    assert {n for n, _ in ranks[0]} == {"sonic.comm.all_gather", "sonic.comm.all_to_all"}
    assert all(b > 0 for _, b in ranks[0])


def _spec(workload):
    spec = harness.load_spec(workload)
    spec.config.update(TINY)
    return spec


def test_trace_0_makes_no_live_span(monkeypatch):
    from sonic_tpu_torch.utils import trace as ptrace

    def refused(*a, **kw):
        raise AssertionError("a recording or a live span in a run with --trace 0")

    monkeypatch.setattr(ptrace, "recording", refused)
    monkeypatch.setattr(ptrace, "_Span", refused)
    torch.set_num_threads(1)
    res = harness.run_cell(_spec("prove.n16q64"), SEED, 0.0, False, "cpu", workers=1)
    assert res["correct"]


@pytest.mark.parametrize("spans", [True, False], ids=["program", "program_without_spans"])
def test_a_traced_run_reads_the_programs_spans_and_counter(spans, monkeypatch):
    """The profiler replaced by a fixed profile (the CPU has no device
    trace), with or without program spans in its idle gaps."""
    idle = {"sonic.msm.combine": 0.25, "outside the named functions": 0.25} if spans else {
        "protocol.combine_windows": 0.25}
    monkeypatch.setattr(trace, "profile_call", lambda fn, device, keys: (fn(), trace.Profile(1.0, 0.5, {}, idle, 0)))
    torch.set_num_threads(1)
    res = harness.run_cell(_spec("prove.n16q64"), SEED, 0.0, True, "cpu", workers=1)
    assert res["correct"]
    metrics = res["metrics"]
    assert metrics["bucket_adds.single"]["value"] > 0
    if spans:
        assert metrics["msm_idle_s.single"]["value"] == 0.25 and metrics["poly_idle_s.single"]["value"] == 0
    else:
        assert "msm_idle_s.single" not in metrics and "poly_idle_s.single" not in metrics
