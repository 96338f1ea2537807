"""Seconds a proof in the polynomial layer of `prove_batch`: the batched
r/s/k, s(X, y_j) and s(u, Y) builds, t's batched product and the batched
divisions of the openings."""

SPANS = [
    ("sonic_tpu_torch.protocol", "r_x1_batch"),
    ("sonic_tpu_torch.protocol", "r_at_y_batch"),
    ("sonic_tpu_torch.protocol", "s_at_y_batch"),
    ("sonic_tpu_torch.protocol", "k_at_y_batch"),
    ("sonic_tpu_torch.protocol", "s_at_u_batch"),
    ("sonic_tpu_torch.poly.laurent", "mul_batched"),
    ("sonic_tpu_torch.commitment", "div_by_linear_batched"),
]


def read(run):
    return run.per_proof(SPANS)
