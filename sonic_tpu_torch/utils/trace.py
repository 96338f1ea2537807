"""The program's spans and counters, and torch.profiler capture.

One span system for the whole port. `span(name, **attrs)` marks a block,
or, as a decorator, every call of a function:

    with span("sonic.comm.all_gather", bytes=t.nbytes):
        dist.all_gather(out, t, group=group)

    @span("sonic.poly.mul")
    def mul(p, q, mesh=None): ...

Names are `sonic.<layer>.<what>`; the roots are `sonic.prove` and
`sonic.prove_batch`. A span costs nothing but a global check while
tracing is off, which is when no `recording()` block is open and no
torch profiler is running: it is then a shared no-op (one a name), with
no CUDA event, no record and no `record_function`.

- Under a torch profiler, a span emits `record_function(name)`, so the
  profile holds the program's spans on the clock of the card's kernels.
  `device_trace` writes such a profile as a Chrome trace:

      with device_trace("/tmp/sonic-trace"):
          proof, oracle = prove(...)

  and chrome://tracing or Perfetto opens `trace.json` in that directory
  (host activity always, the card's kernels too when a card is present).
- Inside `recording()`, each span appends one `Record` to an in-memory
  log: its name, id, parent's id and request (its root's id), its host
  start and end (`time.perf_counter_ns`), the increase of each of the
  program's counters (`COUNTERS`) inside it, its `attrs`, and, where
  CUDA is in use when the recording opens, a CUDA event at entry and one
  at exit on the current stream, with no synchronise. Each root records
  an anchor on entry (a synchronise, the host's ns, then an event), and
  when the recording closes every event is placed on the host's clock
  through its root's anchor: `dev_start_ns`, `dev_end_ns`.

      with recording() as records:
          proof, oracle = prove(...)
      # records: [Record], in the order the spans opened
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import sys
import time

import torch

_PKG = __name__.split(".")[0]

# the program's counters a record holds the increase of: name -> (module, attribute)
COUNTERS = {
    "mont_mul.launches": (f"{_PKG}.fields.mont_mul", "launches"),
    "bucket_acc.launches": (f"{_PKG}.msm.bucket_acc", "launches"),
    "bucket_acc.entries": (f"{_PKG}.msm.bucket_acc", "entries"),
}


@dataclasses.dataclass
class Record:
    """One span of a recording. Times in ns on `time.perf_counter_ns`'s
    clock; the device's are None where no CUDA event was recorded."""

    name: str
    id: int
    parent: int | None  # the enclosing span's id
    request: int  # the root's id (the root's own for a root)
    host_start_ns: int = 0
    host_end_ns: int = 0
    dev_start_ns: float | None = None  # when the device reached the span's entry
    dev_end_ns: float | None = None  # ... and its exit
    counters: dict = dataclasses.field(default_factory=dict)  # name -> increase
    attrs: dict = dataclasses.field(default_factory=dict)


def _counters() -> list:
    out = []
    for mod, attr in COUNTERS.values():
        m = sys.modules.get(mod)
        out.append(getattr(m, attr, 0) if m is not None else 0)
    return out


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Recording:
    def __init__(self):
        self.records: list[Record] = []
        self.open: list[Record] = []
        self.ids = itertools.count(1)
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.before: dict = {}  # id -> counters at entry
        self.events: dict = {}  # id -> [entry event, exit event]
        self.anchors: dict = {}  # root id -> (host ns, event)

    def enter(self, name: str, attrs: dict) -> Record:
        parent = self.open[-1] if self.open else None
        i = next(self.ids)
        r = Record(name, i, parent and parent.id, parent.request if parent else i, attrs=attrs)
        if parent is None and self.cuda:
            torch.cuda.synchronize()
            self.anchors[i] = (time.perf_counter_ns(), _event())
        self.records.append(r)
        self.open.append(r)
        self.before[i] = _counters()
        if self.cuda:
            self.events[i] = [_event(), None]
        r.host_start_ns = time.perf_counter_ns()
        return r

    def exit(self, r: Record) -> None:
        r.host_end_ns = time.perf_counter_ns()
        if self.cuda:
            self.events[r.id][1] = _event()
        r.counters = {k: v - b for k, v, b in zip(COUNTERS, _counters(), self.before.pop(r.id))}
        self.open.remove(r)

    def resolve(self) -> None:
        """Every event on the host's clock, through its root's anchor."""
        if not self.events:
            return
        torch.cuda.synchronize()
        for r in self.records:
            start, end = self.events[r.id]
            host, anchor = self.anchors[r.request]
            r.dev_start_ns = host + anchor.elapsed_time(start) * 1e6
            if end is not None:
                r.dev_end_ns = host + anchor.elapsed_time(end) * 1e6
        self.events.clear()
        self.anchors.clear()


_rec: _Recording | None = None
_profiler_on = torch.autograd._profiler_enabled


def _traced(name: str, attrs: dict, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _rec is None and not _profiler_on():
            return fn(*args, **kwargs)
        with _Span(name, attrs):
            return fn(*args, **kwargs)

    return call


class _Off:
    """A span while tracing is off: entering and leaving it does nothing;
    a function it decorates checks again at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _traced(self.name, {}, fn)


_OFF: dict[str, _Off] = {}


class _Span:
    __slots__ = ("name", "attrs", "_rf", "_r", "_log")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._rf = self._r = None
        if _profiler_on():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._log = _rec
        if self._log is not None:
            self._r = self._log.enter(self.name, self.attrs)
        return self._r

    def __exit__(self, *exc):
        if self._r is not None:
            self._log.exit(self._r)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        return _traced(self.name, self.attrs, fn)


def span(name: str, **attrs):
    """A named span of the program: a context manager, or a decorator of
    a function (see the module docstring); a decorator's span carries
    the name alone."""
    if _rec is None and not _profiler_on():
        off = _OFF.get(name)
        if off is None:
            off = _OFF[name] = _Off(name)
        return off
    return _Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record every span opened inside the block; yields the list the
    records go into, complete (device times placed) once the block ends."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already open")
    rec = _rec = _Recording()
    try:
        yield rec.records
    finally:
        _rec = None
        rec.resolve()


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block, the program's
    spans included, into `log_dir`/trace.json (a no-op when log_dir is
    None and SONIC_TPU_TRACE_DIR is unset)."""
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
