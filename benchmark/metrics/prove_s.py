"""Seconds a proof: the wall time of every `protocol.prove` call of the
window (each ended by a device synchronise) over the proofs made. With a
mesh, rank 0's calls, which wait for the slowest rank."""


def read(run):
    calls = [c for c in run.calls if c.kind == "prove"]
    if not calls:
        return None
    return sum(c.seconds for c in calls) / sum(c.proofs for c in calls)
