"""Kernel-4 calls a proof (the port's counter `poly_div.launches`): the
openings' divisions on the card, one a slice of a batched division and
one a single opening, over the timed calls. A program without the counter
(no `sonic_tpu_torch.poly.div`) gives no reading."""
import importlib.util

KEY = ("sonic_tpu_torch.poly.div", "launches")
COUNTERS = [KEY] if importlib.util.find_spec(KEY[0]) is not None else []


def read(run):
    if KEY not in run.counters or not run.proofs_timed:
        return None
    return run.counters[KEY] / run.proofs_timed
