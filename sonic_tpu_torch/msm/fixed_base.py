"""Fixed-base windowed scalar multiplication: SRS power-table generation.

Port of `sonic_tpu/msm/fixed_base.py`. The SRS is four tables of s_i * G
for ONE base G and 2d+1 scalars each (SRS.hs:33-41). A shared base makes
Pippenger the wrong tool; instead the classic fixed-base window table

    T[w][j] = (j * 2^(c w)) * G      w < W = ceil(256 / c),  j < 2^c

is built once per (group, c, device), and every output point is W
gathered mixed additions:

    s * G = sum_w T[w][digit_w(s)]

batched over all the scalars: 32 batched additions per point at c = 8,
against ~510 group ops for the 255-step double-and-add ladder. The digit-0
column holds the point at infinity, which add_mixed absorbs, so zero digits
need no masking.

The table is built on the host (c W doublings and W (2^c - 1) additions of
the golden affine law, about half a second per group) and uploaded once;
it is compared in affine form, so how it is built does not matter. Large
batches run in chunks of rows, as the reference's `max_chunk` split
does, but sized by the step budget (`budget.BASE_ROW_BYTES` a row of each
group) rather than by the reference's 2^16-row compile guard: the G2
tables at d = 458,772 are 1.84 M rows of Fq2 Jacobians. The reference's
pad-to-256 rows existed for XLA compiles and is not ported.
"""
from __future__ import annotations

import torch

from .. import budget, golden
from ..curve.group import Affine, GroupOps, Jacobian, cat
from .pippenger import DEFAULT_C, _digits

SCALAR_BITS = 256  # 16 limbs of 16 bits

_TABLE_CACHE: dict = {}
_HOST_ADD = {"G1": golden.g1_add, "G2": golden.g2_add}


def chunk_rows(group: GroupOps) -> int:
    """Rows of one `fixed_base_mul` chunk: as many as the step budget
    holds at `budget.BASE_ROW_BYTES` a row of the group."""
    return budget.per_step(budget.BASE_ROW_BYTES[group.name])


def table(group: GroupOps, c: int, device) -> Affine:
    """The (W, 2^c) affine window table of the group's generator, cached
    per (group, c, device)."""
    device = torch.device(device)
    key = (group.name, c, device)
    cached = _TABLE_CACHE.get(key)
    if cached is not None:
        return cached
    add = _HOST_ADD[group.name]
    W = -(-SCALAR_BITS // c)
    pts, base = [], group.gen  # base = 2^(c w) G
    for _ in range(W):
        acc = None
        pts.append(acc)
        for _ in range((1 << c) - 1):
            acc = add(acc, base)
            pts.append(acc)
        base = add(acc, base)
    flat = group.from_host(pts, device)
    tab = Affine(*(a.reshape((W, 1 << c) + a.shape[1:]) for a in flat))
    _TABLE_CACHE[key] = tab
    return tab


def fixed_base_mul(group: GroupOps, scalars_std: torch.Tensor, c: int = DEFAULT_C) -> Jacobian:
    """scalars (N, 16) standard-form Fr limbs -> (N,) Jacobian batch of
    s_i * generator: W gathered mixed additions, each batched over N.

    Above `chunk_rows(group)` rows the batch runs in chunks of that many
    rows, as the reference's `max_chunk` split does; the rows do not
    depend on the chunking."""
    n, rows = scalars_std.shape[0], chunk_rows(group)
    if n > rows:
        return cat([fixed_base_mul(group, scalars_std[i : i + rows], c) for i in range(0, n, rows)])
    tab = table(group, c, scalars_std.device)
    digits = _digits(scalars_std, c)  # (N, W)
    acc = group.infinity((scalars_std.shape[0],), scalars_std.device)
    for w in range(digits.shape[1]):
        j = digits[:, w]
        acc = group.add_mixed(acc, Affine(tab.x[w, j], tab.y[w, j], tab.inf[w, j]))
    return acc
