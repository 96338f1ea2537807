"""Profiler hooks: torch.profiler capture and named spans.

Port of `sonic_tpu/utils/trace.py`. A caller captures a trace of any block:

    with device_trace("/tmp/sonic-trace"):
        proof, oracle = prove(...)

and opens the Chrome trace it writes (`trace.json` in that directory) in
chrome://tracing or Perfetto. `annotate` adds named spans, so the protocol
phases are visible in the trace. Host (CPU) activity is always recorded,
the card's kernels too when a card is present.
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block into
    `log_dir`/trace.json (a no-op when log_dir is None and
    SONIC_TPU_TRACE_DIR is unset)."""
    log_dir = log_dir or os.environ.get("SONIC_TPU_TRACE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span context manager for phase attribution inside traces."""
    return torch.profiler.record_function(name)
