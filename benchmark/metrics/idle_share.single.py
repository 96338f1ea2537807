"""The device's idle share of the profiled call, in %: 1 - the union of
its operations' intervals over the call's wall time (averaged over the
ranks)."""
from benchmark import yardstick


def read(run):
    return yardstick.idle_share(run)
