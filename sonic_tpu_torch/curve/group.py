"""Complete projective group ops for G1 and G2 over limb fields, in PyTorch.

Port of `sonic_tpu/curve/group.py`. One group law, `GroupOps`, bound to a
field-op namespace: `g1` runs it over Fq, `g2` over Fq2. The formulas are
the reference's, step for step: the complete Renes-Costello-Batina 2016
formulas (eprint 2015/1060, a = 0, algorithms 7-9), valid for every input
pair, so a batch needs no per-edge-case branches.

    G1: y^2 = x^3 + 4       over Fq,  coordinates (..., 24),    3b = 12
    G2: y^2 = x^3 + 4(u+1)  over Fq2, coordinates (..., 2, 24), 3b = 12 + 12u

Homogeneous projective coordinates (X : Y : Z), affine = (X/Z, Y/Z),
infinity = (0 : 1 : 0). The class keeps the reference's name `Jacobian`.
Each group op stacks its field products into two `mul_many` calls, one
kernel-1 launch each, in both groups.
"""
from __future__ import annotations

import dataclasses

import torch

from ..fields import constants as C
from ..fields import ext, limb
from ..fields.limb import FQ


@dataclasses.dataclass(frozen=True)
class Jacobian:
    """Projective point batch (X : Y : Z), each (..., L) or (..., 2, L)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __iter__(self):
        return iter((self.x, self.y, self.z))

    def map(self, fn) -> "Jacobian":
        return Jacobian(fn(self.x), fn(self.y), fn(self.z))


Point = Jacobian


@dataclasses.dataclass(frozen=True)
class Affine:
    """Affine point batch: x, y coordinates; inf (...,) bool, True = infinity."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor

    def __iter__(self):
        return iter((self.x, self.y, self.inf))


def cat(points, dim: int = 0) -> Jacobian:
    """Concatenate Jacobian batches along batch axis `dim` (>= 0)."""
    return Jacobian(*(torch.cat([getattr(p, c) for p in points], dim) for c in "xyz"))


class _FqOps:
    """Field-op namespace for Fq (G1 coordinates)."""

    coord_ndim = 1
    zero_host = 0

    @staticmethod
    def add(a, b):
        return limb.add(a, b, FQ)

    @staticmethod
    def sub(a, b):
        return limb.sub(a, b, FQ)

    @staticmethod
    def neg(a):
        return limb.neg(a, FQ)

    @staticmethod
    def mul_small(a, k):
        return limb.mul_small(a, k, FQ)

    @staticmethod
    def mul_b3(a):
        return limb.mul_small(a, 12, FQ)  # 3b for b = 4

    @staticmethod
    def mul_many(pairs):
        return limb.mul_many(pairs, FQ)

    @staticmethod
    def add_many(pairs):
        return limb.add_many(pairs, FQ)

    @staticmethod
    def sub_many(pairs):
        return limb.sub_many(pairs, FQ)

    @staticmethod
    def batch_inv(a):
        return limb.batch_inv(a, FQ)

    @staticmethod
    def is_zero(a):
        return limb.is_zero(a)

    @staticmethod
    def select(cond, a, b):
        return limb.select(cond, a, b)

    @staticmethod
    def zeros(shape=(), device=None):
        return FQ.zeros(shape, device)

    @staticmethod
    def ones(shape=(), device=None):
        return FQ.ones(shape, device)

    @staticmethod
    def from_int(v, device=None):
        return FQ.from_int(v, device=device)

    @staticmethod
    def to_host(a) -> list:
        """(N, L) -> N python ints."""
        return [int(v) for v in FQ.to_int(a.reshape(-1, FQ.nlimbs))]


class _Fq2Ops:
    """Field-op namespace for Fq2 (G2 coordinates)."""

    coord_ndim = 2
    zero_host = (0, 0)

    add = staticmethod(ext.add)
    sub = staticmethod(ext.sub)
    neg = staticmethod(ext.neg)
    mul_small = staticmethod(ext.mul_small)
    mul_b3 = staticmethod(ext.mul_b3)
    mul_many = staticmethod(ext.mul_many)
    add_many = staticmethod(ext.add_many)
    sub_many = staticmethod(ext.sub_many)
    batch_inv = staticmethod(ext.batch_inv)
    is_zero = staticmethod(ext.is_zero)
    select = staticmethod(ext.select)
    zeros = staticmethod(ext.zeros)
    ones = staticmethod(ext.ones)

    @staticmethod
    def from_int(v, device=None):
        return ext.from_int(v, device=device)

    @staticmethod
    def to_host(a) -> list:
        """(N, 2, L) -> N (c0, c1) pairs of python ints."""
        a0, a1 = ext.to_int(a.reshape(-1, 2, FQ.nlimbs))
        return [(int(u), int(v)) for u, v in zip(a0, a1)]


class GroupOps:
    """The curve group law bound to one coordinate field `F`."""

    def __init__(self, F, name: str, gen):
        self.F = F
        self.name = name
        self.gen = gen  # the generator as a host affine point

    # -- constructors ---------------------------------------------------------

    def infinity(self, shape=(), device=None) -> Jacobian:
        F = self.F
        return Jacobian(F.zeros(shape, device), F.ones(shape, device), F.zeros(shape, device))

    def affine_infinity(self, shape=(), device=None) -> Affine:
        F = self.F
        return Affine(F.zeros(shape, device), F.zeros(shape, device),
                      torch.ones(shape, dtype=torch.bool, device=device))

    def generator(self, device=None) -> Affine:
        t = self.from_host([self.gen], device)
        return Affine(t.x[0], t.y[0], t.inf[0])

    def from_host(self, points, device=None) -> Affine:
        """Host affine points (None = infinity) -> an Affine batch (N,)."""
        F = self.F
        pts = list(points)
        return Affine(
            F.from_int([p[0] if p is not None else F.zero_host for p in pts], device),
            F.from_int([p[1] if p is not None else F.zero_host for p in pts], device),
            torch.tensor([p is None for p in pts], dtype=torch.bool, device=device),
        )

    def to_host(self, p: Affine) -> list:
        """An Affine batch (N,) -> host affine points (None = infinity), one fetch."""
        xs, ys = self.F.to_host(p.x), self.F.to_host(p.y)
        return [None if f else (x, y) for x, y, f in zip(xs, ys, p.inf.reshape(-1).tolist())]

    def from_affine(self, p: Affine) -> Jacobian:
        """Affine -> projective: (x, y, 1); the infinity flag -> (0, 1, 0)."""
        F = self.F
        one = F.ones((), p.x.device).expand(p.x.shape)
        zero = torch.zeros_like(p.x)
        return Jacobian(
            F.select(p.inf, zero, p.x),
            F.select(p.inf, one, p.y),
            F.select(p.inf, zero, one),
        )

    def to_affine(self, p: Jacobian) -> Affine:
        """Projective -> affine with ONE batch inversion over all points."""
        F = self.F
        coord = p.z.shape[p.z.dim() - F.coord_ndim :]
        batch = p.z.shape[: p.z.dim() - F.coord_ndim]
        flat = p.map(lambda a: a.reshape((-1,) + coord))
        inf = F.is_zero(flat.z)
        zinv = F.batch_inv(flat.z)
        ax, ay = F.mul_many([(flat.x, zinv), (flat.y, zinv)])
        zero = torch.zeros_like(ax)
        return Affine(
            F.select(inf, zero, ax).reshape(batch + coord),
            F.select(inf, zero, ay).reshape(batch + coord),
            inf.reshape(batch),
        )

    # -- group law -------------------------------------------------------------

    def double(self, p: Jacobian) -> Jacobian:
        """Complete doubling (RCB16 algorithm 9, a = 0): 6M + 2S + 1 mul-by-3b.
        Maps infinity to infinity."""
        F = self.F
        t0, t1, zz, xy = F.mul_many([(p.y, p.y), (p.y, p.z), (p.z, p.z), (p.x, p.y)])
        z3 = F.mul_small(t0, 8)
        t2 = F.mul_b3(zz)
        y3 = F.add(t0, t2)
        t0 = F.sub(t0, F.mul_small(t2, 3))
        x3, z3, ym, xm = F.mul_many([(t2, z3), (t1, z3), (t0, y3), (t0, xy)])
        y3 = F.add(x3, ym)
        x3 = F.mul_small(xm, 2)
        return Jacobian(x3, y3, z3)

    def add(self, p: Jacobian, q: Jacobian) -> Jacobian:
        """Complete projective addition (RCB16 algorithm 7, a = 0): 12M + 2
        mul-by-3b, valid for every input pair."""
        F = self.F
        sxy_p, syz_p, sxz_p, sxy_q, syz_q, sxz_q = F.add_many(
            [
                (p.x, p.y), (p.y, p.z), (p.x, p.z),
                (q.x, q.y), (q.y, q.z), (q.x, q.z),
            ]
        )
        t0, t1, t2, t3, t4, xz = F.mul_many(
            [
                (p.x, q.x), (p.y, q.y), (p.z, q.z),
                (sxy_p, sxy_q), (syz_p, syz_q), (sxz_p, sxz_q),
            ]
        )
        u01, u12, u02 = F.add_many([(t0, t1), (t1, t2), (t0, t2)])
        t3, t4, y3 = F.sub_many([(t3, u01), (t4, u12), (xz, u02)])
        t0 = F.mul_small(t0, 3)
        t2 = F.mul_b3(t2)
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = F.mul_b3(y3)
        m0, m1, m2, m3, m4, m5 = F.mul_many(
            [(t3, t1), (t4, y3), (t1, z3), (y3, t0), (z3, t4), (t0, t3)]
        )
        x3 = F.sub(m0, m1)
        y3, z3 = F.add_many([(m2, m3), (m4, m5)])
        return Jacobian(x3, y3, z3)

    def add_mixed(self, p: Jacobian, q: Affine) -> Jacobian:
        """Complete mixed addition (RCB16 algorithm 8, a = 0, Z2 = 1): 11M +
        2 mul-by-3b. The affine side's infinity flag returns p unchanged."""
        F = self.F
        sxy_p, sxy_q = F.add_many([(p.x, p.y), (q.x, q.y)])
        t0, t1, t3, yz, xz = F.mul_many(
            [(p.x, q.x), (p.y, q.y), (sxy_q, sxy_p), (q.y, p.z), (q.x, p.z)]
        )
        u01, t4, y3 = F.add_many([(t0, t1), (yz, p.y), (xz, p.x)])
        t3 = F.sub(t3, u01)
        t0 = F.mul_small(t0, 3)
        t2 = F.mul_b3(p.z)
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = F.mul_b3(y3)
        m0, m1, m2, m3, m4, m5 = F.mul_many(
            [(t3, t1), (t4, y3), (t1, z3), (y3, t0), (z3, t4), (t0, t3)]
        )
        x3 = F.sub(m0, m1)
        y3, z3 = F.add_many([(m2, m3), (m4, m5)])
        return self.select(q.inf, p, Jacobian(x3, y3, z3))

    def neg(self, p: Jacobian) -> Jacobian:
        return Jacobian(p.x, self.F.neg(p.y), p.z)

    def select(self, cond, a: Jacobian, b: Jacobian) -> Jacobian:
        F = self.F
        return Jacobian(F.select(cond, a.x, b.x), F.select(cond, a.y, b.y), F.select(cond, a.z, b.z))

    # -- scalar multiplication ---------------------------------------------------

    def scalar_mul(self, p: Jacobian, scalar_std: torch.Tensor) -> Jacobian:
        """Double-and-add, MSB first, over the 255-bit ladder, batched.

        scalar_std: Fr elements in STANDARD (non-Montgomery) limb form,
        (..., 16), broadcast-compatible with the point batch."""
        cn = self.F.coord_ndim
        bits = _scalar_bits_msb(scalar_std, C.FR_BITS)
        shape = torch.broadcast_shapes(p.x.shape[: p.x.dim() - cn], scalar_std.shape[:-1])
        p = p.map(lambda a: a.expand(shape + a.shape[a.dim() - cn :]))
        acc = self.infinity(shape, p.x.device)
        for bit in bits:
            acc = self.double(acc)
            acc = self.select(bit != 0, self.add(acc, p), acc)
        return acc


def _scalar_bits_msb(scalar_std: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., L) standard-form limbs -> (nbits, ...) bits, MSB first."""
    bit_idx = torch.arange(nbits - 1, -1, -1, device=scalar_std.device)
    sel = scalar_std[..., bit_idx // C.LIMB_BITS]  # (..., nbits)
    bits = (sel >> (bit_idx % C.LIMB_BITS)) & 1
    return bits.movedim(-1, 0)


class G1(GroupOps):
    def __init__(self):
        super().__init__(_FqOps, "G1", (C.G1_GEN_X, C.G1_GEN_Y))


class G2(GroupOps):
    def __init__(self):
        super().__init__(_Fq2Ops, "G2", (C.G2_GEN_X, C.G2_GEN_Y))


g1 = G1()
g2 = G2()
