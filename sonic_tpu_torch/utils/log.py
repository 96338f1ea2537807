"""JAX-free copy of `sonic_tpu/utils/log.py`. Below this docstring the code
is the original's, line for line.

`sonic_tpu/__init__.py` imports jax whenever any of its submodules is
imported, and `sonic_tpu/` stays as it is, so the port carries its own
copy of this pure-Python module.

Original docstring:

Thin structured logger + phase timing.

The reference has no observability at all (SURVEY.md §5: the example prints
one line). This keeps the same zero-config default (silent unless asked)
while giving the benchmark runner and long-running setup/prove jobs
structured per-phase timings:

  SONIC_TPU_LOG=info  python -m sonic_tpu.example      # human-readable
  SONIC_TPU_LOG=json  ...                              # one JSON per line
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class _Logger:
    def __init__(self, name: str):
        self.name = name

    @property
    def mode(self) -> str:
        return os.environ.get("SONIC_TPU_LOG", "").lower()

    def info(self, event: str, **fields) -> None:
        mode = self.mode
        if not mode or mode in ("0", "off", "none"):
            return
        if mode == "json":
            rec = {"logger": self.name, "event": event, **fields}
            print(json.dumps(rec), file=sys.stderr, flush=True)
        else:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[sonic_tpu.{self.name}] {event} {kv}", file=sys.stderr,
                  flush=True)


_LOGGERS: dict[str, _Logger] = {}


def get_logger(name: str) -> _Logger:
    if name not in _LOGGERS:
        _LOGGERS[name] = _Logger(name)
    return _LOGGERS[name]


@contextlib.contextmanager
def phase_timer(log: _Logger, phase: str, **fields):
    """Time one protocol phase (setup / commit / open / hsc / verify)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info(phase, seconds=round(time.perf_counter() - t0, 4), **fields)
