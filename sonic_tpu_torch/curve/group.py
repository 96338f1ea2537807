"""Complete projective G1 group ops over limb fields, in PyTorch.

Port of `sonic_tpu/curve/group.py`, G1 only (G2 over Fq2 waits for ROADMAP
item 12). The formulas are the reference's, step for step: the complete
Renes-Costello-Batina 2016 formulas (eprint 2015/1060, a = 0, algorithms
7-9), valid for every input pair, so a batch needs no per-edge-case
branches.

    G1: y^2 = x^3 + 4 over Fq, coordinates (..., 24), 3b = 12.

Homogeneous projective coordinates (X : Y : Z), affine = (X/Z, Y/Z),
infinity = (0 : 1 : 0). The class keeps the reference's name `Jacobian`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..fields import constants as C
from ..fields import limb
from ..fields.limb import FQ


@dataclasses.dataclass(frozen=True)
class Jacobian:
    """Projective point batch (X : Y : Z), each (..., L)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __iter__(self):
        return iter((self.x, self.y, self.z))

    def map(self, fn) -> "Jacobian":
        return Jacobian(fn(self.x), fn(self.y), fn(self.z))


@dataclasses.dataclass(frozen=True)
class Affine:
    """Affine point batch: x, y (..., L); inf (...,) bool, True = infinity."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor

    def __iter__(self):
        return iter((self.x, self.y, self.inf))


def cat(points, dim: int = 0) -> Jacobian:
    """Concatenate Jacobian batches along batch axis `dim` (>= 0)."""
    return Jacobian(*(torch.cat([getattr(p, c) for p in points], dim) for c in "xyz"))


class G1:
    """G1 group law on Montgomery Fq limb tensors."""

    name = "G1"

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def infinity(shape=(), device=None) -> Jacobian:
        return Jacobian(FQ.zeros(shape, device), FQ.ones(shape, device), FQ.zeros(shape, device))

    @staticmethod
    def generator(device=None) -> Affine:
        return Affine(
            FQ.from_int(C.G1_GEN_X, device=device),
            FQ.from_int(C.G1_GEN_Y, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_affine(p: Affine) -> Jacobian:
        """Affine -> projective: (x, y, 1); the infinity flag -> (0, 1, 0)."""
        one = FQ.one(p.x.device).expand(p.x.shape)
        zero = torch.zeros_like(p.x)
        return Jacobian(
            limb.select(p.inf, zero, p.x),
            limb.select(p.inf, one, p.y),
            limb.select(p.inf, zero, one),
        )

    @staticmethod
    def to_affine(p: Jacobian) -> Affine:
        """Projective -> affine with ONE batch inversion over all points."""
        shape = p.z.shape
        flat = p.map(lambda a: a.reshape(-1, FQ.nlimbs))
        inf = limb.is_zero(flat.z)
        zinv = limb.batch_inv(flat.z, FQ)
        ax, ay = limb.mul_many([(flat.x, zinv), (flat.y, zinv)], FQ)
        zero = torch.zeros_like(ax)
        return Affine(
            limb.select(inf, zero, ax).reshape(shape),
            limb.select(inf, zero, ay).reshape(shape),
            inf.reshape(shape[:-1]),
        )

    # -- group law -------------------------------------------------------------

    @staticmethod
    def double(p: Jacobian) -> Jacobian:
        """Complete doubling (RCB16 algorithm 9, a = 0): 6M + 2S + 1 mul-by-3b.
        Maps infinity to infinity."""
        t0, t1, zz, xy = limb.mul_many(
            [(p.y, p.y), (p.y, p.z), (p.z, p.z), (p.x, p.y)], FQ
        )
        z3 = limb.mul_small(t0, 8, FQ)
        t2 = limb.mul_small(zz, 12, FQ)
        y3 = limb.add(t0, t2, FQ)
        t0 = limb.sub(t0, limb.mul_small(t2, 3, FQ), FQ)
        x3, z3, ym, xm = limb.mul_many(
            [(t2, z3), (t1, z3), (t0, y3), (t0, xy)], FQ
        )
        y3 = limb.add(x3, ym, FQ)
        x3 = limb.mul_small(xm, 2, FQ)
        return Jacobian(x3, y3, z3)

    @staticmethod
    def add(p: Jacobian, q: Jacobian) -> Jacobian:
        """Complete projective addition (RCB16 algorithm 7, a = 0): 12M + 2
        mul-by-3b, valid for every input pair."""
        sxy_p, syz_p, sxz_p, sxy_q, syz_q, sxz_q = limb.add_many(
            [
                (p.x, p.y), (p.y, p.z), (p.x, p.z),
                (q.x, q.y), (q.y, q.z), (q.x, q.z),
            ],
            FQ,
        )
        t0, t1, t2, t3, t4, xz = limb.mul_many(
            [
                (p.x, q.x), (p.y, q.y), (p.z, q.z),
                (sxy_p, sxy_q), (syz_p, syz_q), (sxz_p, sxz_q),
            ],
            FQ,
        )
        u01, u12, u02 = limb.add_many([(t0, t1), (t1, t2), (t0, t2)], FQ)
        t3, t4, y3 = limb.sub_many([(t3, u01), (t4, u12), (xz, u02)], FQ)
        t0 = limb.mul_small(t0, 3, FQ)
        t2 = limb.mul_small(t2, 12, FQ)
        z3 = limb.add(t1, t2, FQ)
        t1 = limb.sub(t1, t2, FQ)
        y3 = limb.mul_small(y3, 12, FQ)
        m0, m1, m2, m3, m4, m5 = limb.mul_many(
            [(t3, t1), (t4, y3), (t1, z3), (y3, t0), (z3, t4), (t0, t3)], FQ
        )
        x3 = limb.sub(m0, m1, FQ)
        y3, z3 = limb.add_many([(m2, m3), (m4, m5)], FQ)
        return Jacobian(x3, y3, z3)

    @staticmethod
    def add_mixed(p: Jacobian, q: Affine) -> Jacobian:
        """Complete mixed addition (RCB16 algorithm 8, a = 0, Z2 = 1): 11M +
        2 mul-by-3b. The affine side's infinity flag returns p unchanged."""
        sxy_p, sxy_q = limb.add_many([(p.x, p.y), (q.x, q.y)], FQ)
        t0, t1, t3, yz, xz = limb.mul_many(
            [(p.x, q.x), (p.y, q.y), (sxy_q, sxy_p), (q.y, p.z), (q.x, p.z)], FQ
        )
        u01, t4, y3 = limb.add_many([(t0, t1), (yz, p.y), (xz, p.x)], FQ)
        t3 = limb.sub(t3, u01, FQ)
        t0 = limb.mul_small(t0, 3, FQ)
        t2 = limb.mul_small(p.z, 12, FQ)
        z3 = limb.add(t1, t2, FQ)
        t1 = limb.sub(t1, t2, FQ)
        y3 = limb.mul_small(y3, 12, FQ)
        m0, m1, m2, m3, m4, m5 = limb.mul_many(
            [(t3, t1), (t4, y3), (t1, z3), (y3, t0), (z3, t4), (t0, t3)], FQ
        )
        x3 = limb.sub(m0, m1, FQ)
        y3, z3 = limb.add_many([(m2, m3), (m4, m5)], FQ)
        return G1.select(q.inf, p, Jacobian(x3, y3, z3))

    @staticmethod
    def neg(p: Jacobian) -> Jacobian:
        return Jacobian(p.x, limb.neg(p.y, FQ), p.z)

    @staticmethod
    def select(cond, a: Jacobian, b: Jacobian) -> Jacobian:
        return Jacobian(
            limb.select(cond, a.x, b.x),
            limb.select(cond, a.y, b.y),
            limb.select(cond, a.z, b.z),
        )

    # -- scalar multiplication ---------------------------------------------------

    @staticmethod
    def scalar_mul(p: Jacobian, scalar_std: torch.Tensor) -> Jacobian:
        """Double-and-add, MSB first, over the 255-bit ladder, batched.

        scalar_std: Fr elements in STANDARD (non-Montgomery) limb form,
        (..., 16), broadcast-compatible with the point batch."""
        bits = _scalar_bits_msb(scalar_std, C.FR_BITS)
        shape = torch.broadcast_shapes(p.x.shape[:-1], scalar_std.shape[:-1])
        p = p.map(lambda a: a.expand(shape + (FQ.nlimbs,)))
        acc = G1.infinity(shape, p.x.device)
        for bit in bits:
            acc = G1.double(acc)
            acc = G1.select(bit != 0, G1.add(acc, p), acc)
        return acc


def _scalar_bits_msb(scalar_std: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., L) standard-form limbs -> (nbits, ...) bits, MSB first."""
    bit_idx = torch.arange(nbits - 1, -1, -1, device=scalar_std.device)
    sel = scalar_std[..., bit_idx // C.LIMB_BITS]  # (..., nbits)
    bits = (sel >> (bit_idx % C.LIMB_BITS)) & 1
    return bits.movedim(-1, 0)


g1 = G1()
