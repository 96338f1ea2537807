"""Proofs a second: every proof made by the window's `protocol.prove_batch`
calls over the summed wall time of those calls."""


def read(run):
    calls = [c for c in run.calls if c.kind == "prove_batch"]
    if not calls:
        return None
    return sum(c.proofs for c in calls) / sum(c.seconds for c in calls)
