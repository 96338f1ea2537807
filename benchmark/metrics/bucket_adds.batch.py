"""Mixed additions a proof that the bucket sums make (the plans' entries,
kernel 2's work): the program's counter `bucket_acc.entries` over the
timed calls. A program without the counter gives no reading."""
import importlib

KEY = ("sonic_tpu_torch.msm.bucket_acc", "entries")
COUNTERS = [KEY] if hasattr(importlib.import_module(KEY[0]), KEY[1]) else []


def read(run):
    if KEY not in run.counters or not run.proofs_timed:
        return None
    return run.counters[KEY] / run.proofs_timed
