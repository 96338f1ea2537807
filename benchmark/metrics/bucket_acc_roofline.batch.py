"""Kernel 2's share of its roofline in the profiled call: E mixed additions
(counted from the plans the call's MSMs build) at the yardstick's IMAD
cost, over the card's IMAD peak, divided by the device time of the
kernel's scan and merge launches."""
from benchmark import yardstick

HOOKS = {("sonic_tpu_torch.msm.pippenger", "make_plan"): yardstick.plan_entries}


def read(run):
    return yardstick.bucket_acc_roofline(run, next(iter(HOOKS)))
