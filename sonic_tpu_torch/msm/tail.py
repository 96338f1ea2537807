"""The G1 MSM tail: the wrappers of CUDA kernel 3 and their plain twins.

Port of `sonic_tpu/msm/pippenger.py`'s `_bucket_weighted_sum`, `_tree_sum`
and `_window_combine` (plain jnp there: the reference has no kernel for
the tail). The kernel is `csrc/msm_tail.cu`, over the group law of
`csrc/group.cuh`; it was added because the plain tail is a chain of
hundreds of small group ops, each some hundred torch launches, and so
bound by the host's launch cost.

- `bucket_weighted_sum(buckets)`: bucket sums (..., B) -> (...,), the sum
  over b of b * bucket_b, one launch. The kernel takes a running suffix
  sum from the top bucket down; the plain twin a log-depth scan and a
  halving tree. Both are exact sums in the group, in other groupings, so
  they agree after `to_affine`, not in projective form.
- `window_combine(totals, c)`: window totals (..., W) -> (...,), the sum
  over w of totals_w << (c w) by Horner's rule, one launch. Kernel and
  plain twin run the same formulas in the same order on canonical values,
  so they agree bit for bit in projective form.

The wrappers take G1 points on CUDA, contiguous int64 limbs (..., K, 24)
with 16-byte aligned data, and launch the kernel or raise; they count
their launches in `launches`. `pippenger` picks a wrapper for G1 on CUDA
and the plain twin on the CPU and for G2 (no kernel, as kernel 2 has
none): every CPU caller, the tests included, runs the plain twins.
"""
from __future__ import annotations

import torch

from ..curve.group import GroupOps, Jacobian, cat, g1
from ..fields.limb import FQ

launches = 0  # kernel-3 launches


def _tree_sum(p: Jacobian, dim: int, group: GroupOps) -> Jacobian:
    """Sum a Jacobian batch along batch axis `dim` (>= 0) as a halving tree
    of batched complete additions."""
    n = p.x.shape[dim]
    while n > 1:
        h = n // 2
        s = group.add(p.map(lambda a: a.narrow(dim, 0, h)), p.map(lambda a: a.narrow(dim, h, h)))
        if n % 2:
            s = cat([s, p.map(lambda a: a.narrow(dim, 2 * h, 1))], dim)
        p, n = s, s.x.shape[dim]
    return p.map(lambda a: a.squeeze(dim))


def bucket_weighted_sum_plain(buckets: Jacobian, group: GroupOps = g1) -> Jacobian:
    """(..., W, B) -> (..., W): sum_b b * bucket_b = sum_{b>=1} S_b with the
    suffix sums S_b = sum_{j>=b} bucket_j, taken as a log-depth
    (Hillis-Steele) scan, then summed as a halving tree."""
    bd = buckets.x.dim() - group.F.coord_ndim - 1  # the bucket axis
    s = buckets.map(lambda a: a.narrow(bd, 1, a.shape[bd] - 1))
    n = s.x.shape[bd]
    step = 1
    while step < n:
        head = s.map(lambda a: a.narrow(bd, 0, n - step))
        tail = s.map(lambda a: a.narrow(bd, step, n - step))
        added = group.add(head, tail)
        s = cat([added, s.map(lambda a: a.narrow(bd, n - step, step))], bd)
        step *= 2
    return _tree_sum(s, bd, group)


def window_combine_plain(totals: Jacobian, c: int, group: GroupOps = g1) -> Jacobian:
    """(..., W) window totals -> sum_w totals[w] << (c w), by Horner's rule."""
    wd = totals.x.dim() - group.F.coord_ndim - 1  # the window axis
    W = totals.x.shape[wd]
    res = totals.map(lambda a: a.select(wd, W - 1))
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            res = group.double(res)
        res = group.add(res, totals.map(lambda a: a.select(wd, w)))
    return res


def _rows(name: str, p: Jacobian) -> tuple:
    """Check what the kernel takes: G1 coordinates (..., K, 24), int64,
    contiguous, 16-byte aligned, on one CUDA device. Returns (rows, K)."""
    dev, shape = p.x.device, tuple(p.x.shape)
    for a in p:
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"{name}: coordinates on {a.device} and {dev}; one CUDA device expected")
        if a.dtype != torch.int64:
            raise TypeError(f"{name}: dtype {a.dtype}; int64 limbs expected")
        if tuple(a.shape) != shape or a.dim() < 2 or shape[-1] != FQ.nlimbs:
            raise ValueError(f"{name}: coordinates {tuple(a.shape)}; (..., K, {FQ.nlimbs}) expected")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name}: coordinates must be contiguous and 16-byte aligned")
    K = shape[-2]
    if K < 1:
        raise ValueError(f"{name}: {K} windows or buckets")
    return p.x.numel() // (K * FQ.nlimbs), K


def _launch(name: str, entry: str, p: Jacobian, *args) -> Jacobian:
    global launches
    from .. import kernels

    R, K = _rows(name, p)
    out = torch.empty((3,) + tuple(p.x.shape[:-2]) + (FQ.nlimbs,), dtype=torch.int64, device=p.x.device)
    stream = torch.cuda.current_stream(p.x.device).cuda_stream
    rc = getattr(kernels.lib(), entry)(p.x.data_ptr(), p.y.data_ptr(), p.z.data_ptr(), out.data_ptr(),
                                       R, K, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches += 1
    return Jacobian(out[0], out[1], out[2])


def bucket_weighted_sum(buckets: Jacobian) -> Jacobian:
    """G1 bucket sums (..., B, 24) on CUDA -> (..., 24): kernel 3."""
    return _launch("bucket_weighted_sum", "sonic_bucket_weighted_sum", buckets)


def window_combine(totals: Jacobian, c: int) -> Jacobian:
    """G1 window totals (..., W, 24) on CUDA -> (..., 24): kernel 3;
    1 <= c <= 16."""
    if not 1 <= c <= 16:
        raise ValueError(f"window_combine: window size c={c}; 1 <= c <= 16 expected")
    return _launch("window_combine", "sonic_window_combine", totals, c)
