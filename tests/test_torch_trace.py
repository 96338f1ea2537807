"""PyTorch port, the program's spans and counters (utils/trace.py): free
while tracing is off; under `recording()`, every layer's span of a tiny
`prove` and `prove_batch`, nested in its root; the bucket-sums spans'
counter deltas against the plans; `SRS.new`'s phases as spans. CPU only,
so the records hold host times and no device times. The circuit is the
smallest with a helper instance (n = 2, q = 1): a prove of it still takes
about 16 s of one CPU core, so the file makes three, one a test.
"""
import random

import pytest
import torch

from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch import protocol
from sonic_tpu_torch.circuit import random_circuit
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.msm import bucket_acc, pippenger
from sonic_tpu_torch.srs import SRS
from sonic_tpu_torch.utils import trace

torch.set_num_threads(1)

N, Q = 2, 1

LAYERS = ["sonic.protocol.helper", "sonic.protocol.fetch", "sonic.poly.build", "sonic.poly.s_yj",
          "sonic.poly.s_uY", "sonic.poly.mul", "sonic.poly.div", "sonic.msm.lay_out", "sonic.msm.plan",
          "sonic.msm.bucket_sums", "sonic.msm.weighted_sum", "sonic.msm.combine"]


@pytest.fixture(scope="module")
def tiny():
    rng = random.Random(8)
    pairs = [random_circuit(rng, n=N, q=Q)]
    srs = SRS.new(7 * N + 20, rng.randrange(2, gp.P), rng.randrange(2, gp.P), h_mode="verifier",
                  n_hints=[N], device="cpu")
    dcs = [DeviceCircuit.from_host(c, device="cpu") for c, _ in pairs]
    das = [DeviceAssignment.from_host(a, device="cpu") for _, a in pairs]
    rnds = [gp.Randomness.generate(rng, m=Q) for _ in pairs]
    return srs, dcs, das, rnds


def _prove(tiny, root):
    srs, dcs, das, rnds = tiny
    if root == "sonic.prove":
        return [protocol.prove(srs, das[0], dcs[0], rnds[0])]
    return protocol.prove_batch(srs, das, dcs, rnds)


def test_a_span_is_one_shared_no_op_while_tracing_is_off():
    off = trace.span("sonic.test.off")
    assert off is trace.span("sonic.test.off", bytes=8) and isinstance(off, trace._Off)
    with off as entered:
        assert entered is None
    assert trace._rec is None


def _check_nested(records, root):
    first = records[0]
    assert first.name == root and first.parent is None
    by_id = {r.id: r for r in records}
    assert set(LAYERS) <= {r.name for r in records}
    for r in records:
        assert r.request == first.id and r.dev_start_ns is None  # no CUDA here
        assert r.host_start_ns <= r.host_end_ns
        if r is first:
            continue
        parent = by_id[r.parent]
        assert parent.host_start_ns <= r.host_start_ns and r.host_end_ns <= parent.host_end_ns

    def ancestors(r):
        while r.parent is not None:
            r = by_id[r.parent]
            yield r.name

    s_yj = [r for r in records if r.name == "sonic.poly.s_yj"]
    assert s_yj and all("sonic.protocol.helper" in ancestors(r) for r in s_yj)
    assert [by_id[r.parent].name for r in records if r.name == "sonic.protocol.fetch"] == [root]


def test_a_prove_while_tracing_is_off_makes_no_live_span_and_no_event(tiny, monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("a live span or a CUDA event with tracing off")

    monkeypatch.setattr(trace, "_Span", refused)
    monkeypatch.setattr(trace, "_event", refused)
    assert _prove(tiny, "sonic.prove")


def test_a_recorded_prove_holds_every_layer_span_and_the_plans_entries(tiny, monkeypatch):
    planned = []
    real = pippenger.make_plan

    def make_plan(*args, **kwargs):
        plan = real(*args, **kwargs)
        planned.append(plan.entries)
        return plan

    monkeypatch.setattr(pippenger, "make_plan", make_plan)
    before = bucket_acc.entries
    with trace.recording() as records:
        _prove(tiny, "sonic.prove")
    _check_nested(records, "sonic.prove")
    grew = bucket_acc.entries - before
    spans = [r for r in records if r.name == "sonic.msm.bucket_sums"]
    assert len(spans) == len(planned) > 0
    assert sum(r.counters["bucket_acc.entries"] for r in spans) == grew == sum(planned) > 0
    assert records[0].counters["bucket_acc.entries"] == grew


def test_prove_batch_records_every_layer_span(tiny):
    with trace.recording() as records:
        _prove(tiny, "sonic.prove_batch")
    _check_nested(records, "sonic.prove_batch")


def test_srs_new_phases_are_spans():
    with trace.recording() as records:
        SRS.new(2, 5, 7, h_mode="full", device="cpu")
    top = [r for r in records if r.parent is None]
    assert [r.name for r in top] == ["sonic.srs.powers", "sonic.srs.G1", "sonic.srs.G2"]
    assert top[0].attrs == {"d": 2} and top[1].attrs == {"rows": 5}
    with pytest.raises(RuntimeError, match="already open"):
        with trace.recording():
            with trace.recording():
                pass
