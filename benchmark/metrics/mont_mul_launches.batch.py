"""Kernel-1 launches a proof (the port's counter `mont_mul.launches`): a
count of host dispatches of the field layer."""

COUNTERS = [("sonic_tpu_torch.fields.mont_mul", "launches")]


def read(run):
    if not run.proofs_timed:
        return None
    return run.counters[COUNTERS[0]] / run.proofs_timed
