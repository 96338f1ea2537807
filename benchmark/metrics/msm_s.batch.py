"""Seconds a proof in the commitment and MSM layer of `prove_batch`: digits and
layout, bucket plans, bucket sums (kernel 2), bucket weighted sums and
the one window combine of all MSMs."""

SPANS = [
    ("sonic_tpu_torch.msm.pippenger", "_lay_out"),
    ("sonic_tpu_torch.msm.pippenger", "make_plan"),
    ("sonic_tpu_torch.msm.pippenger", "bucket_sums"),
    ("sonic_tpu_torch.msm.pippenger", "_bucket_weighted_sum"),
    ("sonic_tpu_torch.protocol", "combine_windows"),
]


def read(run):
    return run.per_proof(SPANS)
