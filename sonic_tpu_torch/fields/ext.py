"""Fq2 = Fq[u]/(u^2 + 1) over limb tensors, in PyTorch: the G2 coordinate
field.

Port of `sonic_tpu/fields/ext.py`. Elements have shape (..., 2, L): the
component axis (c0, c1), then the Fq limbs (Montgomery form, int64).

Every Fq2 product reaches kernel 1 in ONE launch: the three Karatsuba
products of a batch are stacked into one `limb.mul`, and `mul_many` stacks
k independent Fq2 products before that, so k products are still one launch.
"""
from __future__ import annotations

import torch

from . import limb
from .limb import FQ


def make(c0, c1):
    return torch.stack([c0, c1], -2)


def c0(a):
    return a[..., 0, :]


def c1(a):
    return a[..., 1, :]


def zeros(shape=(), device=None):
    return torch.zeros(tuple(shape) + (2, FQ.nlimbs), dtype=torch.int64, device=device)


def ones(shape=(), device=None):
    return make(FQ.ones(shape, device), FQ.zeros(shape, device))


def from_int(pairs, mont: bool = True, device=None):
    """A (c0, c1) pair of ints, or a list of pairs -> (..., 2, L)."""
    return FQ.from_int(pairs, mont, device)


def to_int(a, mont: bool = True):
    return (FQ.to_int(c0(a), mont), FQ.to_int(c1(a), mont))


def add(a, b):
    return limb.add(a, b, FQ)  # componentwise


def sub(a, b):
    return limb.sub(a, b, FQ)


def neg(a):
    return limb.neg(a, FQ)


def mul(a, b):
    """Karatsuba with u^2 = -1, the three Fq products in one launch:
    (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + ((a0+a1)(b0+b1) - a0 b0 - a1 b1) u."""
    a, b = torch.broadcast_tensors(a, b)
    sa = limb.add(c0(a), c1(a), FQ)
    sb = limb.add(c0(b), c1(b), FQ)
    t0, t1, t2 = limb.mul(
        torch.stack([c0(a), c1(a), sa]), torch.stack([c0(b), c1(b), sb]), FQ
    ).unbind(0)
    return make(limb.sub(t0, t1, FQ), limb.sub(t2, limb.add(t0, t1, FQ), FQ))


def sqr(a):
    """(a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u, both products in one launch."""
    a0, a1 = c0(a), c1(a)
    r0, p = limb.mul(
        torch.stack([limb.add(a0, a1, FQ), a0]), torch.stack([limb.sub(a0, a1, FQ), a1]), FQ
    ).unbind(0)
    return make(r0, limb.mul_small(p, 2, FQ))


def mul_small(a, k: int):
    return limb.mul_small(a, k, FQ)


def mul_b3(a):
    """a * 3b for the G2 curve constant b = 4(u+1): 3b = 12 + 12u.
    (a0 + a1 u)(12 + 12u) = 12(a0 - a1) + 12(a0 + a1) u   (u^2 = -1)."""
    a0, a1 = c0(a), c1(a)
    return limb.mul_small(make(limb.sub(a0, a1, FQ), limb.add(a0, a1, FQ)), 12, FQ)


def mul_many(pairs):
    """k independent Fq2 products as one stacked Karatsuba: one launch."""
    return list(mul(*limb._stack_pairs(pairs)).unbind(0))


def add_many(pairs):
    return list(add(*limb._stack_pairs(pairs)).unbind(0))


def sub_many(pairs):
    return list(sub(*limb._stack_pairs(pairs)).unbind(0))


def _conj_scale(a, ninv):
    """(a0 - a1 u) * ninv for an Fq scalar ninv: both products in one launch."""
    r0, r1 = limb.mul(torch.stack([c0(a), c1(a)]), ninv, FQ).unbind(0)
    return make(r0, limb.neg(r1, FQ))


def _norm(a):
    """a0^2 + a1^2, the two squares in one launch."""
    s0, s1 = limb.mul(a, a, FQ).unbind(-2)
    return limb.add(s0, s1, FQ)


def inv(a):
    """1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); 0 -> 0 (limb.inv(0) = 0)."""
    return _conj_scale(a, limb.inv(_norm(a), FQ))


def batch_inv(a):
    """Inverse of every element along the leading axis: the norm trick over
    one Fq batch inversion."""
    return _conj_scale(a, limb.batch_inv(_norm(a), FQ))


def is_zero(a):
    return (a == 0).all(-1).all(-1)


def eq(a, b):
    return (a == b).all(-1).all(-1)


def select(cond, a, b):
    return torch.where(cond[..., None, None], a, b)
