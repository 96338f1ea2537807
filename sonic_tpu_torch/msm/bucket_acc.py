"""Pippenger bucket accumulation: the wrapper of CUDA kernel 2 and its plain
version.

Port of `sonic_tpu/msm/pallas_acc.py` (`_acc_kernel`, launched by
`_acc_pallas` under `accumulate_pallas` / `accumulate_batched_pallas`). The
kernel is `csrc/bucket_acc.cu`.

Contract (the reference's `_accumulate_buckets_scatter`, G1, signed
digits): points (K, T) affine Fq plus the infinity flag, digits
(K, T, W) or (M, K, T, W) -> the projective bucket grid (K, W, B) or
(M, K, W, B), with B = 2^(c-1) + 1 buckets. Lane k walks its points
t = 0 .. T-1 in order and adds +-P into bucket |digit| with the RCB16
complete mixed addition (-P is y -> -y). Bucket 0 collects the digit-0
points and is never read; an infinity point leaves its bucket as it is.
Kernel and plain version add in the same order, so they agree bit for
bit on the whole grid. The M digit sets of the batched form share one
point table (the hsc helper's MSMs); the plain version treats them as
M*K lanes.

`accumulate` dispatches on the digits' device: CPU tensors take
`accumulate_plain`, CUDA tensors launch the kernel or raise.

`accumulate_plain` is the reference's scan over the port's field layer: its
products go through `limb.mul`, so on CUDA tensors they launch kernel 1
(checked on its own against `mont_mul_plain`); on CPU tensors it is plain
torch throughout.
"""
from __future__ import annotations

import torch

from ..curve.group import Affine, Jacobian, g1
from ..fields import limb
from ..fields.limb import FQ

launches = 0


def accumulate_plain(points: Affine, digits: torch.Tensor, nbuckets: int) -> Jacobian:
    """Scatter-indexed scan, one batched mixed addition per step t over all
    (lane, window) pairs (no index collides within a step)."""
    batched = digits.dim() == 4
    if batched:
        M, K, T, W = digits.shape
        x, y, inf = (
            a.unsqueeze(0).expand((M,) + a.shape).reshape((M * K,) + a.shape[1:])
            for a in points
        )
        digits = digits.reshape(M * K, T, W)
    else:
        x, y, inf = points
    K2, T, W = digits.shape
    L = FQ.nlimbs
    buckets = g1.infinity((K2, W, nbuckets), digits.device)
    k_idx = torch.arange(K2, device=digits.device)[:, None]
    w_idx = torch.arange(W, device=digits.device)[None, :]
    for t in range(T):
        dig = digits[:, t]  # (K2, W)
        bidx = dig.abs()
        y_t = y[:, t]
        y_use = torch.where(
            (dig < 0).unsqueeze(-1),
            limb.neg(y_t, FQ).unsqueeze(1),
            y_t.unsqueeze(1),
        )
        cur = buckets.map(lambda a: a[k_idx, w_idx, bidx])
        q = Affine(x[:, t, None].expand(K2, W, L), y_use, inf[:, t, None].expand(K2, W))
        new = g1.add_mixed(cur, q)
        for a, v in zip(buckets, new):
            a[k_idx, w_idx, bidx] = v
    if batched:
        buckets = buckets.map(lambda a: a.reshape((M, K) + a.shape[1:]))
    return buckets


def accumulate(points: Affine, digits: torch.Tensor, nbuckets: int) -> Jacobian:
    if digits.numel() and int(digits.abs().max()) >= nbuckets:
        raise ValueError(f"bucket_acc: a digit outside (-{nbuckets}, {nbuckets})")
    if digits.device.type == "cpu":
        return accumulate_plain(points, digits, nbuckets)
    return _launch(points, digits, nbuckets)


def _launch(points: Affine, digits: torch.Tensor, nbuckets: int) -> Jacobian:
    global launches
    from .. import kernels

    dev = digits.device
    if dev.type != "cuda":
        raise ValueError(f"bucket_acc: digits on {dev}")
    batched = digits.dim() == 4
    if not batched:
        digits = digits.unsqueeze(0)
    if digits.dim() != 4:
        raise ValueError(f"bucket_acc: digits of shape {tuple(digits.shape)}")
    M, K, T, W = digits.shape
    L = FQ.nlimbs
    for a in (points.x, points.y):
        if a.device != dev or a.dtype != torch.int64 or tuple(a.shape) != (K, T, L):
            raise ValueError(
                f"bucket_acc: coordinates {a.dtype} {tuple(a.shape)} on {a.device}; "
                f"int64 {(K, T, L)} on {dev} expected"
            )
    if points.inf.device != dev or tuple(points.inf.shape) != (K, T):
        raise ValueError(f"bucket_acc: infinity flags {tuple(points.inf.shape)} on {points.inf.device}")
    if not 2 <= nbuckets <= (1 << 15) + 1:
        raise ValueError(f"bucket_acc: {nbuckets} buckets")
    xs = points.x.contiguous()
    ys = points.y.contiguous()
    infs = points.inf.to(torch.uint8).contiguous()
    digs = digits.to(torch.int32).contiguous()
    out = torch.empty((3, M, K, W, nbuckets, L), dtype=torch.int64, device=dev)
    if out.numel():
        rc = kernels.lib().sonic_bucket_acc(
            xs.data_ptr(),
            ys.data_ptr(),
            infs.data_ptr(),
            digs.data_ptr(),
            out.data_ptr(),
            M,
            K,
            T,
            W,
            nbuckets,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"bucket_acc kernel launch failed: CUDA error {rc}")
        launches += 1
    res = Jacobian(out[0], out[1], out[2])
    return res if batched else res.map(lambda a: a[0])
