"""Seconds a proof in the helper (`hsc_prove_device`: its s(X, y_j) and
s(u, Y) builds, m commitments and 3m + 1 openings), synchronising timers."""

SPANS = [("sonic_tpu_torch.protocol", "hsc_prove_device")]


def read(run):
    return run.per_proof(SPANS)
