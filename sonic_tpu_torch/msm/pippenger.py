"""Multi-scalar multiplication (Pippenger) over G1, in PyTorch.

Port of `sonic_tpu/msm/pippenger.py` (G1 and signed digits only):

  - scalars split into W + 1 signed c-bit digits (`_signed_digits`);
  - points split across K lanes; the scan phase (kernel 2,
    `msm/bucket_acc.py`) adds each lane's points into its
    (lane, window, |digit|) bucket;
  - the tail in plain torch: lanes folded as a halving tree, buckets
    weighted-summed, windows combined with c doublings each.

`msm_batched` runs M MSMs that share one point table as one scan launch and
one batched tail. `msm_windows` stops before the window combine, so a
caller with many MSMs (the prover) finishes them all in one batched
`combine_windows`.

Window size and lane count on CUDA: the scan kernel runs one thread per
(MSM, lane, window), so K is chosen to put about 2^15 threads on the card
(M*K*W ~ 2^15, tens of thousands rather than the TPU's 128 lanes). The tail
then folds an (M, K, W, B) grid of about 2^15 * B points in plain torch, so
c = 6 (B = 33 buckets, W = 44 windows) keeps that grid near 10^6 points;
c = 8 would quadruple it, and smaller c adds windows to the serial window
combine. On the CPU (the tests' plain path) every step of the scan is one
batched mixed addition whose cost is mostly per-op overhead, while the
fold's cost grows with K*W*B, so 16 lanes; c follows the reference's CPU
`_pick_c`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..curve.group import Affine, Jacobian, g1, cat
from ..fields import constants as C
from .bucket_acc import accumulate

CUDA_C = 6
CUDA_THREADS = 1 << 15
CPU_LANES = 16
CPU_STEPS = 64
CPU_SMALL_C = 4


def _pick_c(n: int, device) -> int:
    if torch.device(device).type == "cuda":
        return CUDA_C
    if n <= 256:
        return CPU_SMALL_C
    if n <= 4096:
        return 7
    if n <= 1 << 15:
        return 9
    return 10


def _pick_lanes(n: int, m: int, windows: int, device) -> int:
    if torch.device(device).type == "cuda":
        k = max(1, CUDA_THREADS // (m * windows))
        k = 1 << (k.bit_length() - 1)
    else:
        k = min(CPU_LANES, n // CPU_STEPS)
    return max(1, min(k, n))


def _digits(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """(..., L) standard-form 16-bit limbs -> (..., W) c-bit digits,
    little-endian windows, W = ceil(16 L / c); 1 <= c <= 16."""
    assert 1 <= c <= C.LIMB_BITS
    L = scalars_std.shape[-1]
    W = (L * C.LIMB_BITS + c - 1) // c
    mask = (1 << c) - 1
    cols = []
    for j in range(W):
        li, off = divmod(j * c, C.LIMB_BITS)
        v = scalars_std[..., li] >> off
        if off + c > C.LIMB_BITS and li + 1 < L:
            v = v | (scalars_std[..., li + 1] << (C.LIMB_BITS - off))
        cols.append(v & mask)
    return torch.stack(cols, -1)


def _signed_digits(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """(..., L) limbs -> (..., W+1) signed digits in (-2^(c-1), 2^(c-1)]: a
    digit v > 2^(c-1) becomes v - 2^c with a carry into the next window;
    the last carry gets its own top window."""
    d = _digits(scalars_std, c)
    half, full = 1 << (c - 1), 1 << c
    outs = []
    carry = torch.zeros_like(d[..., 0])
    for j in range(d.shape[-1]):
        v = d[..., j] + carry
        flip = v > half
        outs.append(torch.where(flip, v - full, v))
        carry = flip.long()
    outs.append(carry)
    return torch.stack(outs, -1)


def _tree_sum(p: Jacobian, dim: int) -> Jacobian:
    """Sum a Jacobian batch along batch axis `dim` (negative, counted with
    the limb axis) as a halving tree of batched complete additions."""
    n = p.x.shape[dim]
    while n > 1:
        h = n // 2
        s = g1.add(p.map(lambda a: a.narrow(dim, 0, h)), p.map(lambda a: a.narrow(dim, h, h)))
        if n % 2:
            s = cat([s, p.map(lambda a: a.narrow(dim, 2 * h, 1))], s.x.dim() + dim)
        p, n = s, s.x.shape[dim]
    return p.map(lambda a: a.squeeze(dim))


def _fold_lanes(buckets: Jacobian) -> Jacobian:
    """(..., K, W, B) -> (..., W, B): a halving tree over the lanes, log2(K)
    batched additions instead of the reference's K-step scan."""
    return _tree_sum(buckets, -4)


def _bucket_weighted_sum(buckets: Jacobian) -> Jacobian:
    """(..., W, B) -> (..., W): sum_b b * bucket_b = sum_{b>=1} S_b with the
    suffix sums S_b = sum_{j>=b} bucket_j, taken as a log-depth
    (Hillis-Steele) scan, then summed as a halving tree."""
    s = buckets.map(lambda a: a[..., 1:, :])
    n = s.x.shape[-2]
    step = 1
    while step < n:
        head = s.map(lambda a: a[..., : n - step, :])
        tail = s.map(lambda a: a[..., step:, :])
        added = g1.add(head, tail)
        s = cat([added, s.map(lambda a: a[..., n - step :, :])], s.x.dim() - 2)
        step *= 2
    return _tree_sum(s, -2)


def _window_combine(totals: Jacobian, c: int) -> Jacobian:
    """(..., W) window totals -> sum_w totals[w] << (c w), by Horner's rule."""
    W = totals.x.shape[-2]
    res = totals.map(lambda a: a[..., W - 1, :])
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            res = g1.double(res)
        res = g1.add(res, totals.map(lambda a: a[..., w, :]))
    return res


@dataclasses.dataclass(frozen=True)
class WindowTotals:
    """MSMs before their window combine: the per-window sums (..., W) of a
    batch of MSMs that share the window size c."""

    totals: Jacobian
    c: int


def combine_windows(parts: list[WindowTotals]) -> list[Jacobian]:
    """Finish MSMs: sum_w totals[w] << (c w) for each part, returned with
    the part's leading shape. The combine is a serial chain of ~c W group
    ops whatever the batch, so all parts that share (c, W) run as ONE
    batched chain: the prover finishes its 4m+7 MSMs in one pass."""
    groups: dict = {}
    for i, p in enumerate(parts):
        groups.setdefault((p.c, p.totals.x.shape[-2]), []).append(i)
    out: list = [None] * len(parts)
    for (c, W), idx in groups.items():
        flat = [parts[i].totals.map(lambda a: a.reshape(-1, W, a.shape[-1])) for i in idx]
        res = _window_combine(cat(flat), c)
        start = 0
        for i, f in zip(idx, flat):
            n, lead = f.x.shape[0], parts[i].totals.x.shape[:-2]
            out[i] = res.map(lambda a: a[start : start + n].reshape(lead + a.shape[-1:]))
            start += n
    return out


def _lay_out(points: Affine, scalars_std: torch.Tensor, m: int, c, lanes):
    """Pad N to a multiple of K (zero scalars hit the trash bucket, infinity
    points change nothing) and cut the points into (K, T) lanes: point i
    goes to lane i // T, step i % T."""
    n = scalars_std.shape[-2]
    dev = scalars_std.device
    if c is None:
        c = _pick_c(n, dev)
    W = (scalars_std.shape[-1] * C.LIMB_BITS + c - 1) // c + 1
    K = _pick_lanes(n, m, W, dev) if lanes is None else max(1, min(lanes, n))
    T = -(-n // K)
    pad = K * T - n
    x, y, inf = points
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], 0)
        y = torch.cat([y, y.new_zeros((pad,) + y.shape[1:])], 0)
        inf = torch.cat([inf, inf.new_ones((pad,))], 0)
        zeros = scalars_std.new_zeros(scalars_std.shape[:-2] + (pad, scalars_std.shape[-1]))
        scalars_std = torch.cat([scalars_std, zeros], -2)
    pts = Affine(x.reshape(K, T, -1), y.reshape(K, T, -1), inf.reshape(K, T))
    digits = _signed_digits(scalars_std, c)
    digits = digits.reshape(digits.shape[:-2] + (K, T, W))
    return pts, digits, c, (1 << (c - 1)) + 1


def msm_windows(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
                lanes: int | None = None) -> WindowTotals:
    """The MSMs of `msm` / `msm_batched` up to their window totals: one scan
    launch (kernel 2), the lane fold and the bucket weighted sums. Finish
    them with `combine_windows`."""
    m = scalars_std.shape[0] if scalars_std.dim() == 3 else 1
    pts, digits, c, nb = _lay_out(points, scalars_std, m, c, lanes)
    return WindowTotals(_bucket_weighted_sum(_fold_lanes(accumulate(pts, digits, nb))), c)


def msm(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
        lanes: int | None = None) -> Jacobian:
    """Sum_i scalars[i] * points[i]. points: Affine batch (N,);
    scalars_std: (N, 16) Fr limbs in STANDARD form. Returns one Jacobian."""
    return combine_windows([msm_windows(points, scalars_std, c, lanes)])[0]


def msm_batched(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
                lanes: int | None = None) -> Jacobian:
    """M independent MSMs SHARING one point table: scalars (M, N, 16) ->
    Jacobian batch (M,). One scan launch and one batched tail."""
    return msm(points, scalars_std, c, lanes)
