"""Seconds a proof in the sparse builds' sums over the nonzeros
(`constraints.row_sums`, the program's span `sonic.poly.rows`: gather,
scale, segment sum and one reduction), synchronising timers. A program
without the function, or a dense circuit, gives no reading."""
import importlib

KEY = ("sonic_tpu_torch.constraints", "row_sums")
SPANS = [KEY] if hasattr(importlib.import_module(KEY[0]), KEY[1]) else []


def read(run):
    if not run.span_s.get(KEY):
        return None
    return run.per_proof(SPANS)
