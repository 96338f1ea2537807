"""Seconds a proof on rank 0 in the collectives of `prove(mesh)` (the MSMs'
and the SRS rows' all_gather, the sharded product's all_gather and
all_to_all), waiting for the slowest rank included."""

SPANS = [
    ("sonic_tpu_torch.parallel.mesh", "all_gather_rows"),
    ("sonic_tpu_torch.parallel.ntt_sharded", "all_gather_rows"),
    ("sonic_tpu_torch.parallel.ntt_sharded", "all_to_all_rows"),
]


def read(run):
    return run.per_proof(SPANS)
