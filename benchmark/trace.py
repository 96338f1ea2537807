"""Timers, counters and the device profile of a traced run.

Functions of the port are named as (module, attribute), where the caller
looks them up, as the port's `breakdown.phase_timers` names them. They
are wrapped for the duration of a block and put back afterwards:

- `Spans`: a timer that synchronises the device before and after each
  call, so a call's seconds are its device work too. It perturbs the
  timeline, so only the timed calls of a traced run carry it.
- `Hooks`: a count taken from each call's arguments and result, with no
  synchronisation (a plan's entries, a launch's bytes).
- `profile_call`: one call under torch.profiler, each named function
  marked by `record_function` (no synchronisation), reduced to the
  device's busy seconds (the union of its operations' intervals), each
  kernel's seconds, and the idle seconds by what the host was doing at
  the start of each gap: the innermost named function then running.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import re
import time

import torch

WINDOW = "bench.window"  # the profiled call's own annotation


def _resolve(key):
    mod, attr = key
    return importlib.import_module(mod), attr


def label(key) -> str:
    return f"{key[0].rsplit('.', 1)[-1]}.{key[1]}"


@contextlib.contextmanager
def _patched(wrappers: dict):
    """wrappers: {(module, attribute): fn -> wrapped fn}."""
    saved = []
    try:
        for key, wrap in wrappers.items():
            mod, attr = _resolve(key)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrap(fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Seconds and calls of each function, summed over the block's calls
    (inclusive of functions nested in it)."""

    def __init__(self, keys, device):
        self.keys = list(dict.fromkeys(tuple(k) for k in keys))
        self.device = device
        self.seconds = collections.Counter()
        self.calls = collections.Counter()

    def _wrap(self, key):
        def wrap(fn):
            def timed(*args, **kwargs):
                sync(self.device)
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync(self.device)
                self.seconds[key] += time.perf_counter() - t0
                self.calls[key] += 1
                return out

            return timed

        return wrap

    def on(self):
        return _patched({k: self._wrap(k) for k in self.keys})


class Hooks:
    """totals[(module, attribute)] += count(args, kwargs, result) for
    each call made inside the block."""

    def __init__(self, counts: dict):
        self.counts = {tuple(k): f for k, f in counts.items()}
        self.totals = collections.Counter()

    def _wrap(self, key, count):
        def wrap(fn):
            def counted(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.totals[key] += count(args, kwargs, out)
                return out

            return counted

        return wrap

    def on(self):
        return _patched({k: self._wrap(k, f) for k, f in self.counts.items()})


def read_counters(keys) -> dict:
    """The current values of module-level counters, by (module, attribute)."""
    out = {}
    for key in keys:
        mod, attr = _resolve(tuple(key))
        out[tuple(key)] = getattr(mod, attr)
    return out


class Profile:
    """A profiled call's device time: `window_s` its wall seconds (host
    clock, device synchronised), `busy_s` the union of the device's
    operations' intervals inside it, `kernel_s` seconds by kernel name,
    `idle_s` idle seconds by the host's innermost named function."""

    def __init__(self, window_s, busy_s, kernel_s, idle_s, events):
        self.window_s, self.busy_s = window_s, busy_s
        self.kernel_s, self.idle_s, self.events = kernel_s, idle_s, events

    def kernel_seconds(self, names) -> float:
        """Seconds of the kernels named `names` (in any namespace)."""
        pat = re.compile(r"(^|::)(%s)(\(|<|$)" % "|".join(map(re.escape, names)))
        return sum(s for k, s in self.kernel_s.items() if pat.search(k))


def _annotate(key):
    def wrap(fn):
        name = label(key)

        def marked(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return marked

    return wrap


def profile_call(fn, device, keys):
    """Run fn() once under torch.profiler, with each function of `keys`
    marked; returns (fn's result, Profile). Needs a card: a device
    metric is never read from the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("device metrics need a CUDA card; this run has none")
    from torch.profiler import ProfilerActivity, profile, record_function

    with _patched({tuple(k): _annotate(tuple(k)) for k in keys}):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                sync(device)
                t0 = time.perf_counter()
                out = fn()
                sync(device)
                wall = time.perf_counter() - t0
    return out, reduce_events(prof.profiler.kineto_results.events(), wall)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(spans):
    """Nested host spans (start, end, label) -> non-overlapping segments
    (start, end, innermost label), sorted."""
    segs, stack, cur = [], [], 0  # stack of (end, label)

    def emit(upto):
        nonlocal cur
        if stack and cur < upto:
            segs.append((cur, upto, stack[-1][1]))
        cur = max(cur, upto)

    for s, e, lab in sorted(spans, key=lambda t: (t[0], -t[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, lab))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return segs


def reduce_events(events, wall: float) -> Profile:
    cuda = torch.autograd.DeviceType.CUDA
    win = None
    dev, spans = [], []
    for e in events:
        if e.is_user_annotation():
            if e.device_type() == cuda:
                continue
            s = e.start_ns()
            if e.name() == WINDOW:
                win = (s, s + e.duration_ns())
            else:
                spans.append((s, s + e.duration_ns(), e.name()))
        elif e.device_type() == cuda:
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name()))
    if win is None:
        raise RuntimeError("the profile holds no window annotation")
    lo, hi = win
    kernel_s = collections.Counter()
    for s, e, name in dev:
        kernel_s[name.removeprefix("void ")[:120]] += (e - s) / 1e9
    busy = _merge([(max(s, lo), min(e, hi)) for s, e, _ in dev if e > lo and s < hi])
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    segs = _innermost(spans)
    starts = [s for s, _, _ in segs]
    idle = collections.Counter()
    for gs, ge in gaps:
        i = bisect.bisect_right(starts, gs) - 1
        lab = segs[i][2] if i >= 0 and segs[i][0] <= gs < segs[i][1] else "outside the named functions"
        idle[lab] += (ge - gs) / 1e9
    return Profile(wall, busy_ns / 1e9, dict(kernel_s), dict(idle), len(dev))
