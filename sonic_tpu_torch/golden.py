"""JAX-free copy of `sonic_tpu/golden.py`. Below this docstring the code is
the original's, line for line; its relative imports resolve inside the port.

`sonic_tpu/__init__.py` imports jax whenever any of its submodules is
imported, and `sonic_tpu/` stays as it is, so the port carries its own
copy of this host module.

Original docstring:

Host-side golden implementation: Python-int BLS12-381 arithmetic.

Role: the oracle every TPU kernel is bit-exact-tested against, and the
runtime for O(1) host-side cryptography (the verifier's pairings —
reference `src/Sonic/CommitmentScheme.hs:51-68` does 3 pairings per pcV).

This plays the role GMP plays in the reference stack (GHC Integer inside
galois-field): slow-but-exact bignum arithmetic. Performance-critical bulk
work never runs here.

Conventions:
  - Field elements are plain ints in [0, mod).
  - Fq2 = Fq[u]/(u^2+1) as tuples (c0, c1).
  - G1 points: affine tuples (x, y) with None = infinity.
  - G2 points: affine tuples of Fq2 elements, None = infinity.
"""
from __future__ import annotations

from .fields.constants import (
    Q_MOD,
    R_MOD,
    CURVE_B,
    G1_GEN_X,
    G1_GEN_Y,
    G2_GEN_X,
    G2_GEN_Y,
)

# ---------------------------------------------------------------------------
# Prime fields
# ---------------------------------------------------------------------------


def fr_inv(a: int) -> int:
    return pow(a, -1, R_MOD)


def fq_inv(a: int) -> int:
    return pow(a, -1, Q_MOD)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q_MOD, (a[1] + b[1]) % Q_MOD)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q_MOD, (a[1] - b[1]) % Q_MOD)


def fq2_neg(a):
    return ((-a[0]) % Q_MOD, (-a[1]) % Q_MOD)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % Q_MOD, (t2 - t0 - t1) % Q_MOD)


def fq2_sqr(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    c0 = (a[0] + a[1]) * (a[0] - a[1]) % Q_MOD
    c1 = 2 * a[0] * a[1] % Q_MOD
    return (c0, c1)


def fq2_scalar(a, k: int):
    return (a[0] * k % Q_MOD, a[1] * k % Q_MOD)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q_MOD)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q_MOD
    ninv = fq_inv(norm)
    return (a[0] * ninv % Q_MOD, (-a[1]) * ninv % Q_MOD)


# ---------------------------------------------------------------------------
# Generic short-Weierstrass affine group ops, parameterized by the field.
# Used for both G1 (field = Fq) and G2 (field = Fq2).
# ---------------------------------------------------------------------------


class _FieldOps:
    __slots__ = ("add", "sub", "mul", "neg", "inv", "eq", "zero", "scalar")

    def __init__(self, add, sub, mul, neg, inv, eq, zero, scalar):
        self.add, self.sub, self.mul, self.neg = add, sub, mul, neg
        self.inv, self.eq, self.zero, self.scalar = inv, eq, zero, scalar


_FQ_OPS = _FieldOps(
    add=lambda a, b: (a + b) % Q_MOD,
    sub=lambda a, b: (a - b) % Q_MOD,
    mul=lambda a, b: a * b % Q_MOD,
    neg=lambda a: (-a) % Q_MOD,
    inv=fq_inv,
    eq=lambda a, b: a == b,
    zero=0,
    scalar=lambda a, k: a * k % Q_MOD,
)

_FQ2_OPS = _FieldOps(
    add=fq2_add,
    sub=fq2_sub,
    mul=fq2_mul,
    neg=fq2_neg,
    inv=fq2_inv,
    eq=lambda a, b: a == b,
    zero=FQ2_ZERO,
    scalar=fq2_scalar,
)


def _ec_add(F: _FieldOps, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if F.eq(x1, x2):
        if F.eq(y1, y2):
            if F.eq(y1, F.zero):
                return None
            # doubling: lam = 3 x1^2 / (2 y1)   (a = 0 for BLS12-381)
            lam = F.mul(F.scalar(F.mul(x1, x1), 3), F.inv(F.scalar(y1, 2)))
        else:
            return None  # P + (-P)
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def _ec_neg(F: _FieldOps, p):
    if p is None:
        return None
    return (p[0], F.neg(p[1]))


def _ec_mul(F: _FieldOps, p, k: int):
    k %= R_MOD
    acc = None
    while k:
        if k & 1:
            acc = _ec_add(F, acc, p)
        p = _ec_add(F, p, p)
        k >>= 1
    return acc


# Public G1 / G2 ops -------------------------------------------------------

G1_GEN = (G1_GEN_X, G1_GEN_Y)
G2_GEN = (G2_GEN_X, G2_GEN_Y)


def g1_add(p, q):
    return _ec_add(_FQ_OPS, p, q)


def g1_neg(p):
    return _ec_neg(_FQ_OPS, p)


def g1_mul(p, k: int):
    return _ec_mul(_FQ_OPS, p, k)


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + CURVE_B)) % Q_MOD == 0


def g2_add(p, q):
    return _ec_add(_FQ2_OPS, p, q)


def g2_neg(p):
    return _ec_neg(_FQ2_OPS, p)


def g2_mul(p, k: int):
    return _ec_mul(_FQ2_OPS, p, k)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    b2 = (CURVE_B % Q_MOD, CURVE_B % Q_MOD)  # 4(u+1)
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), b2)
    return lhs == rhs


def g1_msm(points, scalars):
    """Reference MSM (slow; oracle for the TPU Pippenger kernel)."""
    acc = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc
