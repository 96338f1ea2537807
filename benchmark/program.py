"""Readings of the program's own spans in the profiled call.

Under a profiler the program's spans (`sonic_tpu_torch/utils/trace.py`,
named `sonic.<layer>.<what>`) emit `record_function` events, and the
profile's reduction (`trace.reduce_events`) counts them among the named
functions: each device-idle gap goes to the innermost one open on the
host at its start. The program's spans lie inside the harness's labels
of the same functions, so `Profile.idle_s` holds the idle seconds by
program span. Two labelled functions hold no program span: the s(X, y)
builds that the program spans at their call sites
(`signature.s_at_y_batched`, `protocol.s_at_y_batch`); their gaps are the
polynomial layer's.

The proofs of the profiled call are counted by a hook on the prover.
A program without spans gives no reading.
"""
from __future__ import annotations

from benchmark import trace

PREFIX = "sonic."
PROVE = {("sonic_tpu_torch.protocol", "prove"): lambda args, kwargs, out: 1}
PROVE_BATCH = {("sonic_tpu_torch.protocol", "prove_batch"): lambda args, kwargs, out: len(out)}
POLY_LABELS = (trace.label(("sonic_tpu_torch.signature", "s_at_y_batched")),
               trace.label(("sonic_tpu_torch.protocol", "s_at_y_batch")))


def idle_s(run, hooks: dict, prefix: str, labels=()) -> float | None:
    """Device-idle seconds a proof of the profiled call (rank 0's) whose
    innermost open span is a program span named `prefix`..., or one of the
    harness's `labels`; `hooks` counts the call's proofs."""
    key = next(iter(hooks))
    prof = run.profile
    if prof is None or not run.hooks.get(key) or not any(k.startswith(PREFIX) for k in prof.idle_s):
        return None
    return sum(s for k, s in prof.idle_s.items() if k.startswith(prefix) or k in labels) / run.hooks[key]
