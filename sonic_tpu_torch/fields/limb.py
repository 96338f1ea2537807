"""Limb-decomposed modular arithmetic for BLS12-381 Fr and Fq, in PyTorch.

Port of `sonic_tpu/fields/limb.py`.

Representation (the JAX package's, so the two compare value for value): a
field element is a little-endian vector of 16-bit limbs, shape (..., L) with
L = 16 (Fr) or 24 (Fq), in Montgomery form with R = 2^(16 L). The dtype is
torch.int64, not uint32: PyTorch on the CPU has no uint32 `+`, `>>` or `<`.

Every op keeps canonical form (each limb < 2^16, value < modulus) and works
on whatever device its inputs are on. `mul` and `from_mont` go through
`fields/mont_mul.py`: its plain version for CPU tensors, the hand-written
CUDA kernel for CUDA tensors. Everything else is plain torch.

Carries are resolved the reference's way (`_resolve_carries`): the per-limb
generate/propagate flags are packed into one int64 word and ONE integer add
resolves the whole chain, so an add is a constant number of torch ops
whatever the limb count.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import constants as C

MASK = C.LIMB_MASK
SHIFT = C.LIMB_BITS

_CONSTS: dict = {}


def _const(key, make, device) -> torch.Tensor:
    """Per-device cache of small constant tensors."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    k = (key, device)
    t = _CONSTS.get(k)
    if t is None:
        t = make().to(device)
        _CONSTS[k] = t
    return t


def _int_tensor(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static parameters of one prime field in limb form."""

    name: str
    modulus: int
    nlimbs: int

    def __post_init__(self):
        L = self.nlimbs
        r = 1 << (SHIFT * L)
        object.__setattr__(self, "mont_r", r)
        object.__setattr__(self, "mont_r2", r * r % self.modulus)
        object.__setattr__(self, "nprime", (-pow(self.modulus, -1, r)) % r)
        object.__setattr__(self, "mod_limbs", tuple(C.int_to_limbs(self.modulus, L)))
        object.__setattr__(
            self, "nprime_limbs", tuple(C.int_to_limbs(self.nprime, L))
        )
        object.__setattr__(self, "r2_limbs", tuple(C.int_to_limbs(self.mont_r2, L)))
        object.__setattr__(
            self, "one_limbs", tuple(C.int_to_limbs(r % self.modulus, L))
        )

    # -- device constants ------------------------------------------------------

    def mod(self, device) -> torch.Tensor:
        return _const((self.name, "mod"), lambda: _int_tensor(self.mod_limbs), device)

    def one(self, device) -> torch.Tensor:
        """Montgomery one, (L,)."""
        return _const((self.name, "one"), lambda: _int_tensor(self.one_limbs), device)

    def raw_one(self, device) -> torch.Tensor:
        """The integer 1 (Montgomery form of R^-1), (L,): from_mont's operand."""
        return _const(
            (self.name, "raw_one"),
            lambda: _int_tensor([1] + [0] * (self.nlimbs - 1)),
            device,
        )

    def mod_shifted(self, device) -> torch.Tensor:
        """N * R as 2L limbs: the modulus in the upper half."""
        return _const(
            (self.name, "mod_shifted"),
            lambda: _int_tensor((0,) * self.nlimbs + self.mod_limbs),
            device,
        )

    def r2(self, device) -> torch.Tensor:
        return _const((self.name, "r2"), lambda: _int_tensor(self.r2_limbs), device)

    def toeplitz(self, which: str, out_cols: int, device) -> torch.Tensor:
        """(L, out_cols) float64 matrix T with T[i, i + j] = limb j of the
        constant, so that a (..., L) @ T is the constant's limb convolution."""

        def make():
            limbs = self.nprime_limbs if which == "nprime" else self.mod_limbs
            L = self.nlimbs
            t = torch.zeros(L, out_cols, dtype=torch.float64)
            for i in range(L):
                for j in range(min(L, out_cols - i)):
                    t[i, i + j] = limbs[j]
            return t

        return _const((self.name, which, out_cols), make, device)

    # -- host-side converters --------------------------------------------------

    def from_int(self, v, mont: bool = True, device=None) -> torch.Tensor:
        """Python int (or nested list of ints) -> limb tensor (Montgomery)."""
        arr = np.asarray(v, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [int(x) % self.modulus for x in arr.reshape(-1)]
        if mont and flat.size:
            flat = flat * self.mont_r % self.modulus
        out = np.zeros((flat.size, self.nlimbs), np.int64)
        for i in range(self.nlimbs):
            if flat.size:
                out[:, i] = ((flat >> (SHIFT * i)) & MASK).astype(np.int64)
        t = torch.from_numpy(out.reshape(arr.shape + (self.nlimbs,)))
        return t.to(device) if device is not None else t

    def to_int(self, a, mont: bool = True):
        """Limb tensor -> Python int (1-D input) or object array of ints."""
        arr = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        vals = np.zeros(arr.shape[:-1], dtype=object)
        for i in range(self.nlimbs):
            vals = vals + (arr[..., i].astype(object) << (SHIFT * i))
        if mont:
            vals = vals * pow(self.mont_r, -1, self.modulus) % self.modulus
        if arr.ndim == 1:
            return int(vals)
        return vals

    def zeros(self, shape=(), device=None) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.nlimbs,), dtype=torch.int64, device=device)

    def ones(self, shape=(), device=None) -> torch.Tensor:
        return self.one(device or "cpu").expand(tuple(shape) + (self.nlimbs,)).clone()


FR = FieldSpec("Fr", C.R_MOD, C.FR_LIMBS)
FQ = FieldSpec("Fq", C.Q_MOD, C.FQ_LIMBS)


# ---------------------------------------------------------------------------
# Carry machinery (int64 limbs along the LAST axis)
# ---------------------------------------------------------------------------


def _resolve(g: torch.Tensor, p: torch.Tensor):
    """g, p: (..., n) int64 in {0, 1}, n <= 62 -> the carry into each limb.

    c_{i+1} = g_i | (p_i & c_i) is the internal carry chain of the integer
    sum A + B with A = g|p, B = g (see sonic_tpu limb._resolve_carries), so
    one add of the packed flag words resolves every limb at once."""
    n = g.shape[-1]
    dev = g.device
    iota = _const(("iota", n), lambda: torch.arange(n, dtype=torch.int64), dev)
    w = _const(("pow2", n), lambda: torch.ones(n, dtype=torch.int64) << torch.arange(n), dev)
    gw = (g * w).sum(-1)
    a = gw | (p * w).sum(-1)
    c = a ^ gw ^ (a + gw)
    return (c.unsqueeze(-1) >> iota) & 1


def _carry(cols: torch.Tensor, out_limbs: int, rounds: int) -> torch.Tensor:
    """Uncarried column sums -> canonical 16-bit limbs, truncated or padded
    to out_limbs. `rounds` ripple rounds first bring every column below
    2^17 (1 round for columns < 2^32, 2 for columns < 2^40)."""
    k = cols.shape[-1]
    if k < out_limbs:
        pad = cols.new_zeros(cols.shape[:-1] + (out_limbs - k,))
        cols = torch.cat([cols, pad], -1)
    elif k > out_limbs:
        cols = cols[..., :out_limbs]
    for _ in range(rounds):
        hi = cols >> SHIFT
        cols = cols & MASK
        cols[..., 1:] += hi[..., :-1]
    low = cols & MASK
    cin = _resolve(cols >> SHIFT, (low == MASK).long())
    return (low + cin) & MASK


def _bias(n: int, device) -> torch.Tensor:
    """Per-limb bias [2^17, 2^17 - 2, ..., 2^17 - 2] of n limbs: it makes
    every limb of a signed column vector positive and adds exactly
    2 * 2^(16 n) to its value."""
    return _const(
        ("bias", n),
        lambda: torch.tensor([1 << 17] + [(1 << 17) - 2] * (n - 1), dtype=torch.int64),
        device,
    )


def _signed_low(d: torch.Tensor, rounds: int):
    """Signed columns d (..., n), |d_i| < 2^17 (2^40 with rounds=2), of a
    value |V| < 2^(16 n) -> (V mod 2^(16 n) as canonical limbs, V >= 0).

    V + 2 * 2^(16 n) is positive; carried over n+1 limbs its top limb is 2
    when V >= 0 and 1 when V < 0."""
    n = d.shape[-1]
    e = _carry(d + _bias(n, d.device), n + 1, rounds)
    return e[..., :n], e[..., n] == 2


def _sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """a - b limb-wise -> (difference mod 2^(16 L), borrow (...,) 0/1)."""
    low, nonneg = _signed_low(a - b, 1)
    return low, (~nonneg).long()


def _cond_sub_mod(x: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    diff, borrow = _sub_limbs(x, spec.mod(x.device))
    return torch.where((borrow == 0).unsqueeze(-1), diff, x)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums of the full limb product (..., La) x (..., Lb) ->
    (..., La + Lb - 1) int64, not carried; each column is below 2^37.

    Small batches (where op count dominates) take one outer product and the
    reference's shear: padding each row to width La + Lb and re-reading the
    flat buffer with width La + Lb - 1 shifts row i right by exactly i, so a
    sum over rows gives the columns. Large batches accumulate row by row
    and never hold the (..., La, Lb) outer product."""
    La, Lb = a.shape[-1], b.shape[-1]
    out = La + Lb - 1
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    if math.prod(shape) <= _SHEAR_MAX_BATCH:
        p = torch.nn.functional.pad(a.unsqueeze(-1) * b.unsqueeze(-2), (0, out + 1 - Lb))
        flat = p.flatten(-2)[..., : La * out]
        return flat.reshape(flat.shape[:-1] + (La, out)).sum(-2)
    cols = torch.zeros(shape + (out,), dtype=torch.int64, device=a.device)
    for i in range(La):
        cols[..., i : i + Lb] += a[..., i : i + 1] * b
    return cols


_SHEAR_MAX_BATCH = 1024


def _conv_const(a: torch.Tensor, toeplitz: torch.Tensor) -> torch.Tensor:
    """Limb convolution with a constant, as one float64 matrix product. It
    is exact: every product and partial sum is an integer below 2^37."""
    return (a.to(torch.float64) @ toeplitz).to(torch.int64)


# ---------------------------------------------------------------------------
# Public field ops (all keep canonical Montgomery form)
# ---------------------------------------------------------------------------


def add(a, b, spec: FieldSpec):
    """(a + b) mod N. 2N < R for both fields, so S = a + b fits in L limbs;
    S and S - N are carried together and the one that is >= 0 < N wins."""
    s = a + b
    low, nonneg = _signed_low(torch.stack([s, s - spec.mod(s.device)]), 1)
    return torch.where(nonneg[1].unsqueeze(-1), low[1], low[0])


def sub(a, b, spec: FieldSpec):
    """(a - b) mod N: D = a - b and D + N carried together."""
    d = a - b
    low, nonneg = _signed_low(torch.stack([d, d + spec.mod(d.device)]), 1)
    return torch.where(nonneg[0].unsqueeze(-1), low[0], low[1])


def neg(a, spec: FieldSpec):
    return sub(torch.zeros_like(a), a, spec)


def mul(a, b, spec: FieldSpec):
    """Montgomery product a*b*R^-1 mod N, canonical: the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors (fields/mont_mul.py)."""
    from .mont_mul import mont_mul

    return mont_mul(a, b, spec)


def sqr(a, spec: FieldSpec):
    return mul(a, a, spec)


def _stack_pairs(pairs):
    flat = torch.broadcast_tensors(*[x for pair in pairs for x in pair])
    return torch.stack(flat[0::2]), torch.stack(flat[1::2])


def mul_many(pairs, spec: FieldSpec):
    """k independent products as ONE batched mul (one kernel launch)."""
    return list(mul(*_stack_pairs(pairs), spec).unbind(0))


def add_many(pairs, spec: FieldSpec):
    return list(add(*_stack_pairs(pairs), spec).unbind(0))


def sub_many(pairs, spec: FieldSpec):
    return list(sub(*_stack_pairs(pairs), spec).unbind(0))


def mul_small(a, k: int, spec: FieldSpec):
    """a * k for a small python int k, via an addition chain."""
    if k == 0:
        return torch.zeros_like(a)
    acc = None
    for i in range(k.bit_length() - 1, -1, -1):
        if acc is not None:
            acc = add(acc, acc, spec)
        if (k >> i) & 1:
            acc = a if acc is None else add(acc, a, spec)
    return acc


def to_mont(a, spec: FieldSpec):
    return mul(a, spec.r2(a.device), spec)


def from_mont(a, spec: FieldSpec):
    """Montgomery -> standard form: mul(a, 1) = a*R^-1, canonical."""
    return mul(a, spec.raw_one(a.device), spec)


def inv(a, spec: FieldSpec):
    """Fermat inversion a^(N-2); stays in Montgomery form. 0 -> 0."""
    return pow_fixed(a, spec.modulus - 2, spec)


def _scan_mul(x: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Inclusive prefix products along axis 0 (Hillis-Steele, log depth)."""
    n = x.shape[0]
    s = 1
    while s < n:
        x = torch.cat([x[:s], mul(x[s:], x[:-s], spec)], 0)
        s *= 2
    return x


def batch_inv(a, spec: FieldSpec):
    """Inverse of every element along the LEADING axis with ONE Fermat
    inversion: inv(a_i) = (prod_{j<i} a_j)(prod_{j>i} a_j) / prod_j a_j,
    the prefix and suffix products taken as log-depth scans. Zero maps to
    zero. Each output is the exact field inverse, as in the reference's
    chunked Montgomery trick."""
    n = a.shape[0]
    if n == 0:
        return a.clone()
    zero = is_zero(a).unsqueeze(-1)
    one = spec.one(a.device).expand(a.shape[1:])
    safe = torch.where(zero, one, a)
    pre = _scan_mul(safe, spec)
    suf = _scan_mul(safe.flip(0), spec).flip(0)
    total_inv = inv(pre[-1], spec)
    pre_ex = torch.cat([one[None], pre[:-1]], 0)
    suf_ex = torch.cat([suf[1:], one[None]], 0)
    out = mul(mul(pre_ex, suf_ex, spec), total_inv, spec)
    return torch.where(zero, torch.zeros_like(out), out)


def is_zero(a) -> torch.Tensor:
    """Elementwise zero test over the limb axis -> bool (...,)."""
    return (a == 0).all(-1)


def eq(a, b) -> torch.Tensor:
    return (a == b).all(-1)


def select(cond, a, b):
    """Branchless select: cond (...,) bool; a, b limb tensors."""
    return torch.where(cond.unsqueeze(-1), a, b)


def pow_fixed(a, exponent: int, spec: FieldSpec):
    """a^exponent for a python-int exponent >= 0 (square and multiply)."""
    if exponent == 0:
        return spec.one(a.device).expand(a.shape).clone()
    bits = bin(exponent)[3:]  # below the leading one, msb first
    acc = a
    for bit in bits:
        acc = sqr(acc, spec)
        if bit == "1":
            acc = mul(acc, a, spec)
    return acc


def pow_int(z, spec: FieldSpec, exp: int):
    """z^exp for a python int exp (negative -> via the inverse)."""
    if exp < 0:
        return pow_fixed(inv(z, spec), -exp, spec)
    return pow_fixed(z, exp, spec)


def sum_mod(a, spec: FieldSpec, axis: int = 0):
    """Modular sum along `axis` (not the limb axis): a halving tree of adds."""
    a = a.movedim(axis, 0)
    n = a.shape[0]
    if n == 0:
        return torch.zeros(a.shape[1:], dtype=torch.int64, device=a.device)
    while n > 1:
        half = n // 2
        merged = add(a[:half], a[half : 2 * half], spec)
        if n % 2:
            merged = torch.cat([merged, a[2 * half :]], 0)
        a = merged
        n = a.shape[0]
    return a[0]


def powers(z, spec: FieldSpec, count: int):
    """[z^0, z^1, ..., z^(count-1)] along a NEW leading axis: (count, ..., L).

    z may be batched (..., L). The ladder doubles its length each round
    (block [k, 2k) = block [0, k) * z^k), so it costs log2(count) launches."""
    one = spec.one(z.device).expand(z.shape)
    if count == 0:
        return z.new_zeros((0,) + z.shape)
    out = one[None].clone()
    zk = z
    while out.shape[0] < count:
        need = min(out.shape[0], count - out.shape[0])
        out = torch.cat([out, mul(out[:need], zk, spec)], 0)
        if out.shape[0] < count:
            zk = sqr(zk, spec)
    return out
