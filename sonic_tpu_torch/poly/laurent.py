"""Dense Laurent polynomials over Fr, in PyTorch.

Port of `sonic_tpu/poly/laurent.py`. A polynomial is a dense coefficient
tensor plus an exponent offset:

    poly  ==  sum_i  coeffs[i] * X^(offset + i)

coeffs: (D, 16) int64 Montgomery-form Fr limbs. offset: int.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from .. import budget
from ..fields import limb
from ..fields.limb import FR
from ..utils.trace import span


@dataclasses.dataclass(frozen=True)
class Laurent:
    offset: int
    coeffs: torch.Tensor  # (D, L)

    @property
    def length(self) -> int:
        return self.coeffs.shape[0]

    @property
    def max_exp(self) -> int:
        return self.offset + self.length - 1

    @classmethod
    def from_terms(cls, terms: dict[int, int], device=None) -> "Laurent":
        """{exponent: int coefficient} -> dense Laurent."""
        if not terms:
            return cls(0, FR.zeros((0,), device))
        lo, hi = min(terms), max(terms)
        return cls(lo, FR.from_int([terms.get(e, 0) for e in range(lo, hi + 1)], device=device))

    def to_terms(self) -> dict[int, int]:
        """Dense -> sparse {exponent: int}, dropping zeros."""
        vals = FR.to_int(self.coeffs.reshape(-1, FR.nlimbs)) if self.length else []
        return {self.offset + i: int(v) for i, v in enumerate(vals) if int(v) != 0}


def _pad(c: torch.Tensor, pre: int, post: int, axis: int = 0) -> torch.Tensor:
    shape = list(c.shape)
    parts = []
    if pre:
        shape[axis] = pre
        parts.append(c.new_zeros(shape))
    parts.append(c)
    if post:
        shape[axis] = post
        parts.append(c.new_zeros(shape))
    return torch.cat(parts, axis) if len(parts) > 1 else c


def zero(device=None) -> Laurent:
    """The zero polynomial: one zero coefficient at X^0."""
    return Laurent(0, FR.zeros((1,), device))


def align(p: Laurent, q: Laurent):
    """Pad both coefficient tensors onto the union exponent range."""
    lo = min(p.offset, q.offset)
    width = max(p.max_exp, q.max_exp) - lo + 1

    def pad(r: Laurent):
        pre = r.offset - lo
        return _pad(r.coeffs, pre, width - pre - r.length)

    return pad(p), pad(q), lo


def add(p: Laurent, q: Laurent) -> Laurent:
    a, b, lo = align(p, q)
    return Laurent(lo, limb.add(a, b, FR))


def sub(p: Laurent, q: Laurent) -> Laurent:
    a, b, lo = align(p, q)
    return Laurent(lo, limb.sub(a, b, FR))


def neg(p: Laurent) -> Laurent:
    return Laurent(p.offset, limb.neg(p.coeffs, FR))


def scale(p: Laurent, c) -> Laurent:
    """Multiply every coefficient by the Fr element c (L,)."""
    return Laurent(p.offset, limb.mul(p.coeffs, c, FR))


def shift(p: Laurent, k: int) -> Laurent:
    """Multiply by X^k (exponent shift; free)."""
    return Laurent(p.offset + k, p.coeffs)


def _conv_coeffs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of coefficient tensors (..., Da, L) x (..., Db, L)
    -> (..., Da+Db-1, L): all pairwise Fr products, then modular
    anti-diagonal sums."""
    Da, Db = a.shape[-2], b.shape[-2]
    out_len = Da + Db - 1
    prod = limb.mul(a.unsqueeze(-2), b.unsqueeze(-3), FR)  # (..., Da, Db, L)
    j = torch.arange(out_len)[None, :] - torch.arange(Da)[:, None]  # (Da, out)
    valid = ((j >= 0) & (j < Db)).to(a.device)
    idx = j.clamp(0, Db - 1).to(a.device)
    idx = idx.reshape((1,) * (prod.dim() - 3) + idx.shape + (1,))
    gathered = torch.take_along_dim(prod, idx, dim=-2)  # (..., Da, out, L)
    gathered = torch.where(valid.unsqueeze(-1), gathered, torch.zeros_like(gathered))
    return limb.sum_mod(gathered, FR, axis=-3)


# At or above this many pairwise products, NTT multiplication is used.
_NTT_THRESHOLD = 64 * 64


def _ntt_threshold() -> int:
    """Pairwise-product count at which NTT multiplication is used: the
    reference's rule, overridable through SONIC_TPU_NTT_THRESHOLD (read on
    every call, as the JAX package reads it), so small runs can take the
    NTT and the sharded four-step NTT paths."""
    v = os.environ.get("SONIC_TPU_NTT_THRESHOLD")
    return int(v) if v else _NTT_THRESHOLD


@span("sonic.poly.mul")
def mul(p: Laurent, q: Laurent, mesh=None) -> Laurent:
    """Polynomial product: schoolbook below `_ntt_threshold()` pairwise
    products, NTT at or above it. With `mesh`, the NTT is the four-step
    one sharded over the ranks (parallel/ntt_sharded.py) when its size
    splits over them, else the single-rank one."""
    offset = p.offset + q.offset
    if p.length * q.length >= _ntt_threshold():
        if mesh is not None:
            from ..parallel.ntt_sharded import poly_mul_ntt_sharded, splittable

            if splittable(p.length + q.length - 1, mesh.size()):
                return Laurent(offset, poly_mul_ntt_sharded(p.coeffs, q.coeffs, mesh))
        from .ntt import poly_mul_ntt

        return Laurent(offset, poly_mul_ntt(p.coeffs, q.coeffs))
    return Laurent(offset, _conv_coeffs(p.coeffs, q.coeffs))


def _eval(coeffs: torch.Tensor, z: torch.Tensor, offset: int) -> torch.Tensor:
    """coeffs (D, ..., L) at z (..., L) -> (..., L), times z^offset."""
    pows = limb.powers(z, FR, coeffs.shape[0])
    s = limb.sum_mod(limb.mul(coeffs, pows, FR), FR, axis=0)
    return limb.mul(s, limb.pow_int(z, FR, offset), FR)


def evaluate(p: Laurent, z) -> torch.Tensor:
    """f(z) for an Fr element z (L,) -> (L,), negative exponents included."""
    return _eval(p.coeffs, z, p.offset)


def _div_linear_seq(chat: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Exact division of the ordinary polynomial chat (degree D-1, with
    chat(z) == 0) by (X - z): top-down synthetic division, one step at a
    time. The oracle for the log-depth form below, and the only form that
    handles z = 0."""
    D = chat.shape[0]
    ws = [chat[D - 1]]  # w_{D-2} = c_{D-1}
    for i in range(D - 2, 0, -1):  # w_{i-1} = c_i + z * w_i
        ws.append(limb.add(chat[i], limb.mul(z, ws[-1], FR), FR))
    return torch.stack(ws[::-1], 0)


def _prefix_add(t: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along axis 0 (Hillis-Steele, log depth)."""
    n = t.shape[0]
    s = 1
    while s < n:
        t = torch.cat([t[:s], limb.add(t[s:], t[:-s], FR)], 0)
        s *= 2
    return t


def _div_linear(chat: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Synthetic division quotient without a serial scan: w_{i-1} = c_i +
    z w_i with constant z has the closed form
        w_{D-2-j} = z^j * sum_{k<=j} c_{D-1-k} * z^-k,
    two power ladders and one log-depth prefix sum. REQUIRES z != 0 (every
    protocol divisor is; inv(0) = 0 makes z = 0 wrong).
    chat: (D, ..., L) coefficient-leading; z: (..., L)."""
    D = chat.shape[0]
    crev = chat.flip(0)[: D - 1]  # c_{D-1}, ..., c_1
    t = limb.mul(crev, limb.powers(limb.inv(z, FR), FR, D - 1), FR)
    u = limb.mul(_prefix_add(t), limb.powers(z, FR, D - 1), FR)
    return u.flip(0)


def limb_is_zero_host(x) -> bool:
    return bool((x == 0).all())


@span("sonic.poly.div")
def div_by_linear(p: Laurent, z, fz=None):
    """w(X) = (f(X) - f(z)) / (X - z), exact. Returns (f(z), w) with w at
    offset p.offset and length p.length - 1."""
    if fz is None:
        fz = evaluate(p, z)
    # fhat(X) = X^(-offset) (f(X) - f(z)) is an ordinary poly with fhat(z) = 0
    const_pos = -p.offset
    chat = p.coeffs
    if 0 <= const_pos < p.length:
        chat = chat.clone()
        chat[const_pos] = limb.sub(chat[const_pos], fz, FR)
    elif not limb_is_zero_host(fz):
        raise ValueError("f(z) != 0 but X^0 not inside the dense span")
    return fz, Laurent(p.offset, _div_linear(chat, z))


# ---------------------------------------------------------------------------
# Batched variants: one polynomial family, M points/instances at once (the
# hsc helper's m openings are independent and shape-identical).
# ---------------------------------------------------------------------------


def add_batched(offset_a: int, a: torch.Tensor, offset_b: int, b: torch.Tensor):
    """(M, Da, L) + (M, Db, L) at their offsets -> (union offset, (M, D, L))."""
    lo = min(offset_a, offset_b)
    width = max(offset_a + a.shape[1], offset_b + b.shape[1]) - lo

    def pad(off, c):
        return _pad(c, off - lo, width - (off - lo) - c.shape[1], axis=1)

    return lo, limb.add(pad(offset_a, a), pad(offset_b, b), FR)


@span("sonic.poly.mul")
def mul_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, Da, L) x (M, Db, L) -> (M, Da+Db-1, L); NTT at the threshold,
    its instances in slices within the step budget at `budget.COEFF_BYTES`
    a coefficient of the transform (at least one instance a slice: the
    proof batch's 64 t products at n = 2^16 are transforms of 2^19)."""
    if a.shape[1] * b.shape[1] < _ntt_threshold():
        return _conv_coeffs(a, b)
    from .ntt import poly_mul_ntt

    size = 1 << (a.shape[1] + b.shape[1] - 2).bit_length()  # the transform's length
    per = budget.per_step(budget.COEFF_BYTES * size)
    outs = [poly_mul_ntt(a[i : i + per].transpose(0, 1), b[i : i + per].transpose(0, 1)).transpose(0, 1)
            for i in range(0, a.shape[0], per)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def evaluate_batched(offset: int, coeffs: torch.Tensor, zs: torch.Tensor):
    """f_j(z_j) for coeffs (M, D, L) at one offset and zs (M, L) -> (M, L)."""
    return _eval(coeffs.transpose(0, 1), zs, offset)


@span("sonic.poly.div")
def div_by_linear_batched(offset: int, coeffs: torch.Tensor, zs: torch.Tensor):
    """(f_j(X) - f_j(z_j)) / (X - z_j) for coeffs (M, D, L), zs (M, L) ->
    (fz (M, L), quotients (M, D-1, L) at the same offset). X^0 must lie in
    the dense span. The instances run in slices within the step budget at
    `budget.COEFF_BYTES` a coefficient (at least one instance a slice);
    each instance's result does not depend on the slicing."""
    const_pos = -offset
    if not (0 <= const_pos < coeffs.shape[1]):
        raise ValueError("batched division requires X^0 inside the span")
    M, D = coeffs.shape[:2]
    per = budget.per_step(budget.COEFF_BYTES * D)
    if M > per:
        outs = [div_by_linear_batched(offset, coeffs[i : i + per], zs[i : i + per])
                for i in range(0, M, per)]
        return torch.cat([f for f, _ in outs]), torch.cat([w for _, w in outs])
    fz = evaluate_batched(offset, coeffs, zs)
    chat = coeffs.clone()
    chat[:, const_pos] = limb.sub(coeffs[:, const_pos], fz, FR)
    return fz, _div_linear(chat.transpose(0, 1), zs).transpose(0, 1)
