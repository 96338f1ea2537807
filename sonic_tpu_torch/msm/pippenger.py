"""Multi-scalar multiplication (Pippenger) over G1 and G2, in PyTorch.

Port of `sonic_tpu/msm/pippenger.py` (signed digits only):

  - scalars split into W + 1 signed c-bit digits (`_signed_digits`);
  - the bucket plan (`make_plan`: every nonzero digit on a finite point,
    sorted by (MSM, window, |digit|)) and the bucket sums over it (kernel 2,
    `msm/bucket_acc.py`), which hold each (MSM, window, |digit|) bucket's
    sum directly: no lanes, so no lane fold;
  - the tail (`msm/tail.py`): buckets weighted-summed, windows combined
    with c doublings each; G1 on CUDA as kernel 3, one launch each,
    otherwise as the plain twins (batched torch group ops).

`group` selects the curve group (`g1` by default, as the reference's
`msm_g1`; `msm_g2` for G2); `msm(g1, points, scalars)`, the reference's
order, runs too (`group_first_too`). G1 bucket sums are kernel 2's; G2
has no kernel, as in the reference, and runs the same plan through
`bucket_sums_plain` over G2, whose Fq2 products are kernel 1's on the card,
and the plain tail.

`msm_batched` runs M MSMs that share one point table with one batched
tail. Their digits, plan and bucket sums are built in slices of the M
axis, each within `budget.STEP_BYTES` at `budget.SLOT_BYTES` a digit
slot M N W (the reference cuts M the same way,
`sonic_tpu/msm/pippenger.py:462-490`): one plan over the helper's M = 64
MSMs at n = 2^16 would need ~49 GB. The slices' bucket sums are
concatenated along M, so the bucket weighted sum and the window combine
still run once, whatever the slice count. An MSM whose N W slots alone
exceed the budget is cut along N too, into contiguous slices of the
points (`_n_slices`), each with its own digits, plan and bucket-sums
launch; a slice of M adds its N slices' bucket sums in slice order
before the one weighted sum (t's commitment at n = 2^20 is ~31 GB of
digit slots over 7.34 M points). Sums in the group are exact in any
grouping, so the points and projective sums may differ with the cut but
not the affine results. `slicings` counts the batched calls by (M, N,
slices of M), `n_slicings` the calls cut along N by (M, N, slices of
N). `msm_windows` stops before the window
combine, so a caller with many MSMs (the prover) finishes them all in one
batched `combine_windows`. With a mesh, each rank takes a slice of the
points (`msm_windows`), and the budget applies to that slice.

Window size: c = 6 on CUDA (B = 33 buckets, W = 44 windows); larger c
would cut the scan's entries (~256/c per scalar) but double the buckets
per step of c. On the CPU (the tests' plain path) c follows the
reference's CPU `_pick_c`.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from .. import budget
from ..curve.group import Affine, GroupOps, Jacobian, cat, g1, g2
from ..fields import constants as C
from ..utils.trace import span
from . import tail
from .bucket_acc import bucket_sums, bucket_sums_plain, make_plan

DEFAULT_C = 8  # the reference's default window size (bits); the fixed-base tables' c
CUDA_C = 6
CPU_SMALL_C = 4
# (M, N, slices of M) -> calls of a batched MSM (M > 1), and (M, N, slices
# of N) -> calls cut along N; breakdown's phase tables read them
slicings: collections.Counter = collections.Counter()
n_slicings: collections.Counter = collections.Counter()


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


@span("sonic.msm.weighted_sum")
def _bucket_weighted_sum(buckets: Jacobian, group: GroupOps = g1) -> Jacobian:
    """(..., W, B) -> (..., W): sum_b b * bucket_b. G1 on CUDA: kernel 3
    (`tail.bucket_weighted_sum`, equal as group elements to the plain
    twin); otherwise `tail.bucket_weighted_sum_plain`."""
    if group is g1 and buckets.x.is_cuda:
        return tail.bucket_weighted_sum(buckets.map(lambda a: a.contiguous()))
    return tail.bucket_weighted_sum_plain(buckets, group)


def _window_combine(totals: Jacobian, c: int, group: GroupOps = g1) -> Jacobian:
    """(..., W) window totals -> sum_w totals[w] << (c w), by Horner's rule.
    G1 on CUDA: kernel 3 (`tail.window_combine`, bit-equal to the plain
    twin); otherwise `tail.window_combine_plain`."""
    if group is g1 and totals.x.is_cuda:
        return tail.window_combine(totals.map(lambda a: a.contiguous()), c)
    return tail.window_combine_plain(totals, c, group)


@dataclasses.dataclass(frozen=True)
class WindowTotals:
    """MSMs before their window combine: the per-window sums (..., W) of a
    batch of MSMs that share the window size c, in `group`."""

    totals: Jacobian
    c: int
    group: GroupOps = g1


@span("sonic.msm.combine")
def combine_windows(parts: list[WindowTotals]) -> list[Jacobian]:
    """Finish MSMs: sum_w totals[w] << (c w) for each part, returned with
    the part's leading shape. The combine is a serial chain of ~c W group
    ops whatever the batch, so all parts that share (c, W) run as ONE
    batched chain: the prover finishes its 4m+7 MSMs in one pass."""
    groups: dict = {}
    for i, p in enumerate(parts):
        k = p.group.F.coord_ndim
        groups.setdefault((p.group, p.c, p.totals.x.shape[-1 - k]), []).append(i)
    out: list = [None] * len(parts)
    for (group, c, W), idx in groups.items():
        k = group.F.coord_ndim
        flat = [parts[i].totals.map(lambda a: a.reshape((-1, W) + a.shape[a.dim() - k :]))
                for i in idx]
        res = _window_combine(cat(flat), c, group)
        start = 0
        for i, f in zip(idx, flat):
            n, lead = f.x.shape[0], parts[i].totals.x.shape[: -1 - k]
            out[i] = res.map(lambda a: a[start : start + n].reshape(lead + a.shape[1:]))
            start += n
    return out


@span("sonic.msm.lay_out")
def _lay_out(scalars_std: torch.Tensor, c):
    """Signed digits (..., N, W) of the scalars at window size c (None: the
    device's choice), with c and the bucket count B = 2^(c-1) + 1."""
    if c is None:
        c = _pick_c(scalars_std.shape[-2], scalars_std.device)
    return _signed_digits(scalars_std, c), c, (1 << (c - 1)) + 1


def _m_slices(M: int, N: int, W: int) -> list:
    """[lo, hi) ranges of the M axis, each within the step budget, at
    least one MSM a slice."""
    per = budget.per_step(budget.SLOT_BYTES * N * W)
    return [(lo, min(M, lo + per)) for lo in range(0, M, per)]


def _n_slices(N: int, W: int) -> list:
    """[lo, hi) ranges of the points axis of one MSM, as even as the step
    budget allows: one slice unless the MSM's N W digit slots alone
    exceed it, at least one point a slice."""
    k = max(1, min(N, -(-budget.SLOT_BYTES * N * W // budget.STEP_BYTES)))
    return [(N * i // k, N * (i + 1) // k) for i in range(k)]


def msm_windows(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
                chunks: int | None = None, mesh=None, group: GroupOps = g1) -> WindowTotals:
    """The MSMs of `msm` / `msm_batched` up to their window totals: a
    bucket plan and a bucket-sums launch (kernel 2) for each slice of the
    M axis (`_m_slices`), then the bucket weighted sums of all slices at
    once. `chunks` overrides the plans' chunk count. Finish them with
    `combine_windows`.

    With `mesh` (a 1-D DeviceMesh, see parallel/mesh.py), rank r runs all
    of this on its contiguous slice of the points and of every MSM's
    scalars, and the ranks' window totals are summed in rank order: every
    rank gets the same totals. c is picked from the whole MSM's length, so
    every rank's windows line up; a rank whose slice is empty contributes
    infinity."""
    if mesh is None:
        return _windows(points, scalars_std, c, chunks, group)
    from ..parallel.mesh import row_span, sum_over_ranks

    if c is None:
        c = _pick_c(scalars_std.shape[-2], scalars_std.device)
    lo, hi = row_span(scalars_std.shape[-2], mesh)
    if lo == hi:
        W = _signed_digits(scalars_std[..., :0, :], c).shape[-1]
        mine = WindowTotals(group.infinity(scalars_std.shape[:-2] + (W,), scalars_std.device), c, group)
    else:
        mine = _windows(Affine(points.x[lo:hi], points.y[lo:hi], points.inf[lo:hi]),
                        scalars_std[..., lo:hi, :], c, chunks, group)
    return sum_over_ranks(mine, mesh)


def _windows(points: Affine, scalars_std: torch.Tensor, c, chunks, group: GroupOps) -> WindowTotals:
    sc = scalars_std if scalars_std.dim() == 3 else scalars_std.unsqueeze(0)
    M, N, L = sc.shape
    if c is None:
        c = _pick_c(N, sc.device)
    W = -(-L * C.LIMB_BITS // c) + 1  # windows with the top carry window
    sums, cuts, spans = [], _m_slices(M, N, W), _n_slices(N, W)
    if M > 1:
        slicings[(M, N, len(cuts))] += 1
    if len(spans) > 1:
        n_slicings[(M, N, len(spans))] += 1
    for lo, hi in cuts:
        part = None
        for a, b in spans:
            pts = points if len(spans) == 1 else Affine(points.x[a:b], points.y[a:b], points.inf[a:b])
            digits, c, nb = _lay_out(sc[lo:hi, a:b], c)
            plan = make_plan(pts.inf, digits, nb, chunks)
            del digits  # a slice's digits and plan go before the next slice's
            s = bucket_sums(pts, plan) if group is g1 else bucket_sums_plain(pts, plan, group)
            del plan
            part = s if part is None else group.add(part, s)
        sums.append(part)
    sums = cat(sums) if len(sums) > 1 else sums[0]
    if scalars_std.dim() == 2:
        sums = sums.map(lambda a: a[0])
    return WindowTotals(_bucket_weighted_sum(sums, group), c, group)


def group_first_too(fn):
    """Let `fn(points, scalars_std, ..., group=g1)` also be called in the
    reference's order, `fn(group, points, scalars_std, ...)`: a leading
    GroupOps becomes the `group` keyword."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if args and isinstance(args[0], GroupOps):
            if "group" in kwargs:
                raise TypeError(f"{fn.__name__}: group given twice")
            return fn(*args[1:], group=args[0], **kwargs)
        return fn(*args, **kwargs)

    return call


@group_first_too
def msm(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
        chunks: int | None = None, mesh=None, group: GroupOps = g1) -> Jacobian:
    """Sum_i scalars[i] * points[i]. points: Affine batch (N,) of `group`;
    scalars_std: (N, 16) Fr limbs in STANDARD form. Returns one Jacobian."""
    return combine_windows([msm_windows(points, scalars_std, c, chunks, mesh, group)])[0]


@group_first_too
def msm_batched(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
                chunks: int | None = None, mesh=None, group: GroupOps = g1) -> Jacobian:
    """M independent MSMs SHARING one point table: scalars (M, N, 16) ->
    Jacobian batch (M,). A plan and a kernel launch a slice of M (one
    slice unless the plan would exceed the step budget), one batched
    tail (per rank, with `mesh`)."""
    return msm(points, scalars_std, c, chunks, mesh, group)


def msm_g1(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
           chunks: int | None = None) -> Jacobian:
    return msm(points, scalars_std, c, chunks, group=g1)


def msm_g2(points: Affine, scalars_std: torch.Tensor, c: int | None = None,
           chunks: int | None = None) -> Jacobian:
    """Sum_i scalars[i] * points[i] over G2 points (N,) with (N, 2, 24)
    coordinates."""
    return msm(points, scalars_std, c, chunks, group=g2)
