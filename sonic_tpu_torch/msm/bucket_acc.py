"""Pippenger bucket sums: the wrapper of CUDA kernel 2, its plain version,
and the reference's lane-grid scan.

Port of `sonic_tpu/msm/pallas_acc.py` (`_acc_kernel`, launched by
`_acc_pallas` under `accumulate_pallas` / `accumulate_batched_pallas`)
followed by `sonic_tpu/msm/pippenger.py:_fold_lanes`. The kernel is
`csrc/bucket_acc.cu`.

The function: points, an affine G1 table (N,), and signed digits (M, N, W)
with |d| < B = 2^(c-1) + 1 -> the projective bucket sums (M, W, B): bucket
(m, w, b) is the sum of sign(d) P_n over the n with |digits[m, n, w]| = b,
points at infinity skipped; bucket 0 is infinity. It is what the TPU
kernel's lane grid holds after the lane fold; the lanes were how the TPU
kept 128 vector lanes busy, and this port has none.

The plan (`make_plan`, torch index code on the digits' device) lists every
(m, n, w) with d != 0 and P_n finite, sorted stably by the key
(m W + w) B + |d|, so a bucket's points come in order of n. It is cut into
`chunks` runs of S entries. A chunk walks its run once: a bucket's first
entry sets the running sum to (x, +-y, 1), each further entry adds +-P with
the RCB16 complete mixed addition, and the sum goes out as a partial when
the key changes or the run ends. Partials are numbered in plan order, so a
bucket's partials are contiguous; the merge adds them in that order with
the complete addition, in rounds: while a bucket has more than MERGE_FAN
partials, a round sums each run of MERGE_FAN consecutive ones (one thread
a run), and the last round sums each bucket's remaining ones.

`bucket_sums_plain` executes the same plan in plain torch over the port's
field layer: all chunks advance one step at a time as one batched mixed
addition, then each merge round goes one partial at a time. Kernel and plain
version add in the same order, so they agree bit for bit on the projective
output. On CUDA tensors the plain version's products go through `limb.mul`,
that is kernel 1 (checked on its own against `mont_mul_plain`).

`bucket_sums` dispatches on the plan's device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise. The plan is group-free,
and `scan_plain` / `bucket_sums_plain` take a `group`: G2 MSMs run the
plain version over G2 on every device (the reference has no G2 kernel).

Chunk count: on CUDA, the scan kernel's resident threads on the card (the
occupancy API at its register count), so one wave fills the card whatever
M; on the CPU, runs of at most CPU_STEPS entries, since each step is one
batched torch mixed addition. The merge's fan-in of 2 makes its depth
log2 of a bucket's partials: the rounds run on few threads (one MSM has
only W B buckets), where each serial addition costs its full latency.

`accumulate` / `accumulate_plain` keep the reference scatter scan's lane
grid (`_accumulate_buckets_scatter`) in plain torch on any device; the
MSM no longer uses them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..curve.group import Affine, GroupOps, Jacobian, g1
from ..fields import limb
from ..fields.limb import FQ

launches = 0

CPU_STEPS = 32
MERGE_FAN = 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """The scan order of one bucket-sums call (see the module docstring)."""

    shape: tuple  # (M, W, B)
    npoints: int  # N, rows of the point table
    ent: torch.Tensor  # (E,) int32: n * 2 + (d < 0)
    key: torch.Tensor  # (E,) int32: (m W + w) B + |d|, ascending
    steps: int  # S: entries per chunk (the last chunk may have fewer)
    slot0: torch.Tensor  # (C,) int32: each chunk's first partial slot
    # merge rounds, each (G + 1,) int32: group g sums the round's input
    # [off[g], off[g+1]); the last round's groups are the M W B buckets
    rounds: tuple
    npartials: int

    @property
    def entries(self) -> int:
        return self.key.numel()

    @property
    def chunks(self) -> int:
        return self.slot0.numel()

    def emits(self) -> torch.Tensor:
        """(E,) bool: the entries after which a chunk writes a partial."""
        key, E = self.key, self.entries
        last = torch.ones(E, dtype=torch.bool, device=key.device)
        last[:-1] = key[1:] != key[:-1]
        last |= (torch.arange(E, device=key.device) + 1) % self.steps == 0
        return last

    def to(self, device) -> "Plan":
        return dataclasses.replace(
            self, ent=self.ent.to(device), key=self.key.to(device),
            slot0=self.slot0.to(device), rounds=tuple(r.to(device) for r in self.rounds),
        )


def _pick_chunks(entries: int, device: torch.device) -> int:
    if device.type == "cuda":
        from .. import kernels

        fill = kernels.lib().sonic_bucket_sums_fill(device.index or 0)
        if fill <= 0:
            raise RuntimeError(f"bucket_sums: occupancy query failed: CUDA error {-fill}")
        return fill
    return -(-entries // CPU_STEPS)


def make_plan(inf: torch.Tensor, digits: torch.Tensor, nbuckets: int,
              chunks: int | None = None) -> Plan:
    """The plan for points with infinity flags `inf` (N,) and digits (N, W)
    or (M, N, W), cut into `chunks` runs (None: the device's choice)."""
    if digits.dim() == 2:
        digits = digits.unsqueeze(0)
    if digits.dim() != 3 or tuple(inf.shape) != (digits.shape[1],):
        raise ValueError(f"bucket_sums: digits {tuple(digits.shape)}, infinity flags {tuple(inf.shape)}")
    M, N, W = digits.shape
    B = nbuckets
    if not 2 <= B <= (1 << 15) + 1 or M * W * B >= 1 << 31 or N >= 1 << 30:
        raise ValueError(f"bucket_sums: {B} buckets, digits {tuple(digits.shape)}")
    if digits.numel() and int(digits.abs().max()) >= B:
        raise ValueError(f"bucket_sums: a digit outside (-{B}, {B})")
    dev = digits.device
    live = (digits != 0) & ~inf.to(device=dev, dtype=torch.bool)[None, :, None]
    m, n, w = live.nonzero(as_tuple=True)  # row-major: n ascending within (m, w)
    d = digits[m, n, w]
    key, order = torch.sort((m * W + w) * B + d.abs(), stable=True)
    ent = (n * 2 + (d < 0))[order]
    E = key.numel()
    C = max(1, min(_pick_chunks(E, dev) if chunks is None else chunks, E))
    S = -(-E // C) if E else 1
    C = -(-E // S)
    plan = Plan((M, W, B), N, ent.to(torch.int32), key.to(torch.int32), S,
                torch.zeros(C, dtype=torch.int32, device=dev),
                (torch.zeros(M * W * B + 1, dtype=torch.int32, device=dev),), 0)
    if not E:
        return plan
    last = plan.emits()
    before = torch.cumsum(last, 0) - last.long()  # partials written before each entry
    P = int(before[-1]) + 1
    grid = torch.arange(M * W * B + 1, device=dev)
    return dataclasses.replace(plan, slot0=before[::S].to(torch.int32),
                               rounds=_merge_rounds(torch.searchsorted(key[last], grid)),
                               npartials=P)


def _merge_rounds(off: torch.Tensor) -> tuple:
    """Merge rounds for buckets whose partials are [off[k], off[k+1])."""
    rounds = []
    count = off[1:] - off[:-1]
    while int(count.max()) > MERGE_FAN:
        groups = -(-count // MERGE_FAN)  # each bucket's runs of MERGE_FAN
        bucket = torch.repeat_interleave(torch.arange(count.numel(), device=off.device), groups)
        first = torch.cumsum(groups, 0) - groups  # each bucket's first run
        run = torch.arange(bucket.numel(), device=off.device) - first[bucket]
        starts = off[:-1][bucket] + run * MERGE_FAN
        rounds.append(torch.cat([starts, off[-1:]]).to(torch.int32))
        off = torch.cat([off.new_zeros(1), torch.cumsum(groups, 0)])
        count = groups
    rounds.append(off.to(torch.int32))
    return tuple(rounds)


def _merge_plain(parts: Jacobian, offsets: torch.Tensor, dev, group: GroupOps = g1) -> Jacobian:
    """Group g = the sum of parts[offsets[g] : offsets[g+1]] in order."""
    off = offsets.long()
    count = off[1:] - off[:-1]
    out = group.infinity((count.numel(),), dev)
    have = (count > 0).nonzero()[:, 0]
    start = off[have]
    acc = parts.map(lambda a: a[start])
    r = 1
    while True:
        sel = (count[have] > r).nonzero()[:, 0]
        if not sel.numel():
            break
        new = group.add(acc.map(lambda a: a[sel]), parts.map(lambda a: a[start[sel] + r]))
        for a, v in zip(acc, new):
            a[sel] = v
        r += 1
    for a, v in zip(out, acc):
        a[have] = v
    return out


def scan_plain(points: Affine, plan: Plan, group: GroupOps = g1) -> Jacobian:
    """The plan's partials (P,): step s advances every chunk by one entry
    as one batched mixed addition."""
    dev = plan.key.device
    E, S, C = plan.entries, plan.steps, plan.chunks
    F = group.F
    parts = group.infinity((plan.npartials,), dev)
    if E:
        ent, key = plan.ent.long(), plan.key.long()
        emit = plan.emits()
        slot = torch.cumsum(emit, 0) - 1
        one = F.ones((C,), dev)
        acc = None
        for s in range(S):
            i = torch.arange(C, device=dev) * S + s
            ok = i < E
            i = i.clamp(max=E - 1)
            e = ent[i]
            y = points.y[e >> 1]
            y = F.select((e & 1).bool(), F.neg(y), y)
            q = Affine(points.x[e >> 1], y, torch.zeros(C, dtype=torch.bool, device=dev))
            fresh = Jacobian(q.x, q.y, one)
            if acc is None:
                acc = fresh
            else:
                acc = group.select(key[i] != key[i - 1], fresh, group.add_mixed(acc, q))
            out = (ok & emit[i]).nonzero()[:, 0]
            for a, v in zip(parts, acc):
                a[slot[i[out]]] = v[out]
    return parts


def bucket_sums_plain(points: Affine, plan: Plan, group: GroupOps = g1) -> Jacobian:
    """The plan executed in plain torch over `group`: `scan_plain`, then
    the merge rounds."""
    parts = scan_plain(points, plan, group)
    for off in plan.rounds:
        parts = _merge_plain(parts, off, plan.key.device, group)
    return parts.map(lambda a: a.reshape(plan.shape + a.shape[1:]))


def bucket_sums(points: Affine, plan: Plan) -> Jacobian:
    """Bucket sums (M, W, B) of `plan` over `points`: the plain version on
    the CPU, kernel 2 on CUDA."""
    if plan.key.device.type == "cpu":
        return bucket_sums_plain(points, plan)
    return _launch(points, plan)


def _pack(a: torch.Tensor) -> torch.Tensor:
    """(N, 24) 16-bit limbs -> (N, 12) 32-bit words, as int32 bit patterns."""
    w = a[:, 0::2] | (a[:, 1::2] << 16)
    return w - ((w >> 31) << 32)


def _launch(points: Affine, plan: Plan) -> Jacobian:
    global launches
    from .. import kernels

    dev = plan.key.device
    if dev.type != "cuda":
        raise ValueError(f"bucket_sums: plan on {dev}")
    M, W, B = plan.shape
    L = FQ.nlimbs
    N = plan.npoints
    for a in (points.x, points.y):
        if a.device != dev or a.dtype != torch.int64 or tuple(a.shape) != (N, L):
            raise ValueError(
                f"bucket_sums: coordinates {a.dtype} {tuple(a.shape)} on {a.device}; "
                f"int64 {(N, L)} on {dev} expected"
            )
    for t in (plan.ent, plan.key, plan.slot0, *plan.rounds):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"bucket_sums: plan tensor {t.dtype} on {t.device}")
    lib = kernels.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    pts = torch.cat([_pack(points.x), _pack(points.y)], 1).to(torch.int32).contiguous()
    # scratch: one partial is x, y, z in 12 words each
    parts = torch.empty((max(plan.npartials, 1), 36), dtype=torch.int32, device=dev)
    out = torch.empty((3, M, W, B, L), dtype=torch.int64, device=dev)
    rc = lib.sonic_bucket_scan(pts.data_ptr(), plan.ent.data_ptr(), plan.key.data_ptr(),
                               plan.slot0.data_ptr(), parts.data_ptr(), plan.entries,
                               plan.steps, plan.chunks, stream)
    for r, off in enumerate(plan.rounds):
        if rc != 0:
            break
        final = r == len(plan.rounds) - 1
        dst = None if final else torch.empty((off.numel() - 1, 36), dtype=torch.int32, device=dev)
        rc = lib.sonic_bucket_merge(parts.data_ptr(), off.data_ptr(),
                                    None if final else dst.data_ptr(), out.data_ptr(),
                                    off.numel() - 1, stream)
        parts = dst
    if rc != 0:
        raise RuntimeError(f"bucket_sums kernel launch failed: CUDA error {rc}")
    launches += 1
    return Jacobian(out[0], out[1], out[2])


def accumulate_plain(points: Affine, digits: torch.Tensor, nbuckets: int) -> Jacobian:
    """The reference scatter scan: points (K, T), digits (K, T, W) or
    (M, K, T, W) -> the lane grid (K, W, B) or (M, K, W, B). Lane k walks
    t = 0 .. T-1 and adds +-P into bucket |digit| (bucket 0 collects the
    digit-0 points; an infinity point changes nothing), one batched mixed
    addition per step t over all (lane, window) pairs."""
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
    """`accumulate_plain` after a check that every |digit| < nbuckets."""
    if digits.numel() and int(digits.abs().max()) >= nbuckets:
        raise ValueError(f"bucket_acc: a digit outside (-{nbuckets}, {nbuckets})")
    return accumulate_plain(points, digits, nbuckets)
