"""Seconds a proof in the polynomial layer of `prove`: the r/s/k, s(X, y_j)
and s(u, Y) builds, t's product and the divisions of the openings."""

SPANS = [
    ("sonic_tpu_torch.protocol", "r_x1_poly"),
    ("sonic_tpu_torch.protocol", "r_at_y"),
    ("sonic_tpu_torch.protocol", "s_at_y"),
    ("sonic_tpu_torch.protocol", "k_at_y"),
    ("sonic_tpu_torch.signature", "s_at_y_batched"),
    ("sonic_tpu_torch.signature", "s_at_u_of_y"),
    ("sonic_tpu_torch.poly.laurent", "mul"),
    ("sonic_tpu_torch.commitment", "div_by_linear"),
    ("sonic_tpu_torch.commitment", "div_by_linear_batched"),
]


def read(run):
    return run.per_proof(SPANS)
