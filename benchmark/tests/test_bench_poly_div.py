"""The readers of kernel 4's launch counter (`poly_div_launches.*`), on
synthetic runs: a launch count a timed proof, and no reading from a
program without the counter."""
import importlib.util
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def _run(counters=None, timed=0):
    return harness.Run(setup_s=0.0, calls=[], counters=counters or {}, proofs_timed=timed)


@pytest.mark.parametrize("kind", ["single", "batch"])
def test_poly_div_launches_reads_the_counter(kind, monkeypatch):
    mod = harness.load_metric(f"poly_div_launches.{kind}")
    assert mod.COUNTERS == [mod.KEY] == [("sonic_tpu_torch.poly.div", "launches")]
    assert mod.read(_run({mod.KEY: 45}, timed=3)) == 15
    assert mod.read(_run({mod.KEY: 45})) is None
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == mod.KEY[0] else real(name, *a))
    mod = harness.load_metric(f"poly_div_launches.{kind}")  # a program without kernel 4
    assert mod.COUNTERS == [] and mod.read(_run(timed=3)) is None
