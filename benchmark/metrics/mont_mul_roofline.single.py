"""Kernel 1's share of its roofline in the profiled call: the bytes of every
launch's operands and result, each counted once, over the card's HBM
bandwidth, divided by the kernel's device time."""
from benchmark import yardstick

HOOKS = {("sonic_tpu_torch.fields.mont_mul", "_launch"): yardstick.launch_bytes}


def read(run):
    return yardstick.mont_mul_roofline(run, next(iter(HOOKS)))
