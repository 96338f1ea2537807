"""Seconds a verification: the wall time of `protocol.verify` (device
recompute, host pairings) over the window's proofs, each verified right
after it is made."""


def read(run):
    calls = [c for c in run.calls if c.kind == "verify"]
    if not calls:
        return None
    return sum(c.seconds for c in calls) / sum(c.proofs for c in calls)
