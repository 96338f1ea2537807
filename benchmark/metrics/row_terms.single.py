"""Terms a proof that the sparse builds gather: one a nonzero of the
circuit's rows and a y or u it is evaluated at (s(X, y), the helper's m
s(X, y_j) and s(u, Y): (m + 2) times the nonzeros). The program's counter
`constraints.row_terms` over the timed calls. A program without the
counter, or a dense circuit, gives no reading."""
import importlib

KEY = ("sonic_tpu_torch.constraints", "row_terms")
COUNTERS = [KEY] if hasattr(importlib.import_module(KEY[0]), KEY[1]) else []


def read(run):
    if not run.counters.get(KEY) or not run.proofs_timed:
        return None
    return run.counters[KEY] / run.proofs_timed
