"""JAX-free copy of `sonic_tpu/pairing/host.py`. Below this docstring the code is
the original's, line for line; its relative imports resolve inside the port.

`sonic_tpu/__init__.py` imports jax whenever any of its submodules is
imported, so the port carries its own copy of this host module.
ROADMAP item 16 (a lazy `sonic_tpu/__init__`) removes the copy.

Original docstring:

BLS12-381 optimal ate pairing on host (Python ints).

The verifier's only heavy primitive: `pcV` does 3 pairings per check
(reference src/Sonic/CommitmentScheme.hs:58-68, via the Haskell `pairing`
package). Pairing count is O(m) per verify, never O(n), so a host
implementation is the right cost tier (SURVEY.md §7 stage 3); the
sonic_tpu.native C++ extension accelerates this path when built.

Tower:  Fq2 = Fq[u]/(u^2+1)
        Fq6 = Fq2[v]/(v^3 - xi),  xi = u + 1
        Fq12 = Fq6[w]/(w^2 - v)

Elements: Fq2 = (c0, c1) ints; Fq6 = 3-tuple of Fq2; Fq12 = 2-tuple of Fq6.

G2 points live on the M-type sextic twist y^2 = x^3 + 4(u+1); they are
untwisted into E(Fq12) via psi(x, y) = (x w^-2, y w^-3) and the Miller
loop runs with generic affine line functions over Fq12.
"""
from __future__ import annotations

from ..fields.constants import Q_MOD, R_MOD, BLS_X, BLS_X_IS_NEG
from ..golden import (
    fq2_add,
    fq2_sub,
    fq2_mul,
    fq2_sqr,
    fq2_scalar,
    fq2_neg,
    fq2_inv,
    fq2_conj,
    FQ2_ONE,
    FQ2_ZERO,
)

XI = (1, 1)  # xi = u + 1

# ---------------------------------------------------------------------------
# Fq6
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def _mul_xi(a):
    return fq2_mul(a, XI)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(
        t0,
        _mul_xi(
            fq2_sub(
                fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2)
            )
        ),
    )
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)),
        _mul_xi(t2),
    )
    c2 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1
    )
    return (c0, c1, c2)


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_mul(a0, a0), _mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(_mul_xi(fq2_mul(a2, a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_mul(a1, a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_mul(a0, c0),
        _mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))),
    )
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)
FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def _fq6_mul_v(a):
    # multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)
    return (_mul_xi(a[2]), a[0], a[1])


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, _fq6_mul_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_mul(a0, a0), _fq6_mul_v(fq6_mul(a1, a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_conj(a):
    """Conjugation = Frobenius^6: a0 - a1 w."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


def fq12_eq(a, b) -> bool:
    return a == b


# scalar embeddings ---------------------------------------------------------


def fq12_from_fq(x: int):
    return (((x % Q_MOD, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def fq12_scalar_fq(a, x: int):
    return tuple(
        tuple(
            (c[0] * x % Q_MOD, c[1] * x % Q_MOD) for c in a_i
        )
        for a_i in a
    )


# w powers: w^2 = v, w^6 = xi. Elements x*w^k for x in Fq6 handled via the
# (c0 + c1 w) representation directly.


def _w2_inv():
    """w^-2 = v^-1 as an Fq6 element: v^-1 = v^2 / xi."""
    xi_inv = fq2_inv(XI)
    return (FQ2_ZERO, FQ2_ZERO, xi_inv)  # xi^-1 * v^2


def _w3_inv():
    """w^-3 = w^-2 * w^-1; w^-1 = w / v => x*w^-3 = x * v^-2 * w^.
    Return as ('fq6 factor', uses_w) = v^-2 * w."""
    xi_inv = fq2_inv(XI)
    return (FQ2_ZERO, xi_inv, FQ2_ZERO)  # xi^-1 * v  == v^-2


def untwist(q):
    """G2 affine (x, y) over Fq2 -> point on E(Fq12).

    psi(x, y) = (x * w^-2, y * w^-3):
      x w^-2 = (x * xi^-1 * v^2, 0)           [pure c0 part]
      y w^-3 = (0, y * xi^-1 * v)             [c1 part: (y xi^-1) * v * w]
    """
    x, y = q
    xi_inv = fq2_inv(XI)
    X = ((FQ2_ZERO, FQ2_ZERO, fq2_mul(x, xi_inv)), FQ6_ZERO)
    Y = (FQ6_ZERO, (FQ2_ZERO, fq2_mul(y, xi_inv), FQ2_ZERO))
    return (X, Y)


# ---------------------------------------------------------------------------
# Miller loop with generic affine line functions over Fq12
# ---------------------------------------------------------------------------


def _ec12_double_eval(t, p):
    """Double T on E(Fq12); return (2T, line_{T,T}(P)) for P=(xp, yp) Fq ints."""
    (xt, yt) = t
    xp, yp = p
    three = fq12_from_fq(3)
    two = fq12_from_fq(2)
    lam = fq12_mul(
        fq12_mul(three, fq12_mul(xt, xt)), fq12_inv(fq12_mul(two, yt))
    )
    x3 = fq12_sub(fq12_mul(lam, lam), fq12_mul(two, xt))
    y3 = fq12_sub(fq12_mul(lam, fq12_sub(xt, x3)), yt)
    # line: (xp - xt) * lam - (yp - yt)
    lval = fq12_sub(
        fq12_mul(lam, fq12_sub(fq12_from_fq(xp), xt)),
        fq12_sub(fq12_from_fq(yp), yt),
    )
    return (x3, y3), lval


def _ec12_add_eval(t, q, p):
    """T + Q on E(Fq12); return (T+Q, line_{T,Q}(P))."""
    (xt, yt) = t
    (xq, yq) = q
    xp, yp = p
    lam = fq12_mul(fq12_sub(yq, yt), fq12_inv(fq12_sub(xq, xt)))
    x3 = fq12_sub(fq12_sub(fq12_mul(lam, lam), xt), xq)
    y3 = fq12_sub(fq12_mul(lam, fq12_sub(xt, x3)), yt)
    lval = fq12_sub(
        fq12_mul(lam, fq12_sub(fq12_from_fq(xp), xt)),
        fq12_sub(fq12_from_fq(yp), yt),
    )
    return (x3, y3), lval


def miller_loop_generic(p, q) -> tuple:
    """f_{|t|, Q}(P) with the ate loop count |t| = BLS_X. p: G1 affine ints,
    q: G2 affine Fq2 pairs. Returns Fq12 (pre final-exponentiation),
    conjugated at the end because t < 0 for BLS12-381.

    Generic untwist-into-Fq12 affine formulation; kept as the slow oracle
    the optimized twist-resident loop below is tested against."""
    if p is None or q is None:
        return FQ12_ONE
    Q12 = untwist(q)
    T = Q12
    f = FQ12_ONE
    bits = bin(BLS_X)[3:]  # skip MSB
    for bit in bits:
        T, l = _ec12_double_eval(T, p)
        f = fq12_mul(fq12_sqr(f), l)
        if bit == "1":
            T, l = _ec12_add_eval(T, Q12, p)
            f = fq12_mul(f, l)
    if BLS_X_IS_NEG:
        f = fq12_conj(f)
    return f


_FINAL_EXP = (Q_MOD**12 - 1) // R_MOD


def final_exponentiation_generic(f) -> tuple:
    """f^((q^12-1)/r) by generic square-and-multiply — the slow oracle for
    the Frobenius/cyclotomic fast path below."""
    # easy part: f^(q^6-1) = conj(f) * f^-1 ; then ^(q^2+1)
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    f2 = fq12_mul(fq12_pow(f1, Q_MOD**2), f1)
    # hard part: ^((q^4 - q^2 + 1) / r)
    hard = (Q_MOD**4 - Q_MOD**2 + 1) // R_MOD
    return fq12_pow(f2, hard)


# ---------------------------------------------------------------------------
# Fast path: Frobenius maps, cyclotomic arithmetic, twist-resident Miller
# loop with sparse line multiplication.
#
# This is the standard optimal-ate toolkit for BLS12-381 (Aranha et al.,
# "Faster Explicit Formulas for Computing Pairings over Ordinary Curves";
# Granger–Scott cyclotomic squaring; the x-chain hard part). Replaces the
# reference's generic `pairing` package hot path (pcV cost center,
# src/Sonic/CommitmentScheme.hs:58-68) with the fast algorithms its verifier
# latency budget demands.
# ---------------------------------------------------------------------------


def fq2_pow(a, e: int):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


# Frobenius coefficients. With the tower Fq2[v]/(v^3 - xi), Fq6[w]/(w^2 - v):
#   v^q  = v  * xi^((q-1)/3),   v^(2q) = v^2 * xi^(2(q-1)/3),
#   w^q  = w  * xi^((q-1)/6).
# (q = 1 mod 6 so the exponents are exact.)
_FROB6_C1 = fq2_pow(XI, (Q_MOD - 1) // 3)
_FROB6_C2 = fq2_pow(XI, 2 * (Q_MOD - 1) // 3)
_FROB12_C1 = fq2_pow(XI, (Q_MOD - 1) // 6)


def fq6_frob(a):
    """a^q for a in Fq6 (componentwise Fq2 conjugation + v-power twists)."""
    return (
        fq2_conj(a[0]),
        fq2_mul(fq2_conj(a[1]), _FROB6_C1),
        fq2_mul(fq2_conj(a[2]), _FROB6_C2),
    )


def fq12_frob(a):
    """a^q for a in Fq12."""
    c0 = fq6_frob(a[0])
    c1 = fq6_frob(a[1])
    c1 = tuple(fq2_mul(x, _FROB12_C1) for x in c1)
    return (c0, c1)


def fq12_frob2(a):
    return fq12_frob(fq12_frob(a))


def _fq4_sqr(a, b):
    """(a + b s)^2 in Fq4 = Fq2[s]/(s^2 - xi): returns (a', b')."""
    t0 = fq2_sqr(a)
    t1 = fq2_sqr(b)
    c0 = fq2_add(_mul_xi(t1), t0)
    c1 = fq2_sub(fq2_sub(fq2_sqr(fq2_add(a, b)), t0), t1)
    return c0, c1


def fq12_cyc_sqr(f):
    """Granger–Scott squaring, valid for f in the cyclotomic subgroup
    (i.e. after the easy part of the final exponentiation)."""
    (z0, z4, z3), (z2, z1, z5) = f
    t0, t1 = _fq4_sqr(z0, z1)
    # A
    z0 = fq2_sub(t0, z0)
    z0 = fq2_add(fq2_add(z0, z0), t0)
    z1 = fq2_add(t1, z1)
    z1 = fq2_add(fq2_add(z1, z1), t1)
    t0, t1 = _fq4_sqr(z2, z3)
    t2, t3 = _fq4_sqr(z4, z5)
    # C
    z4 = fq2_sub(t0, z4)
    z4 = fq2_add(fq2_add(z4, z4), t0)
    z5 = fq2_add(t1, z5)
    z5 = fq2_add(fq2_add(z5, z5), t1)
    # B
    t0 = _mul_xi(t3)
    z2 = fq2_add(t0, z2)
    z2 = fq2_add(fq2_add(z2, z2), t0)
    z3 = fq2_sub(t2, z3)
    z3 = fq2_add(fq2_add(z3, z3), t2)
    return ((z0, z4, z3), (z2, z1, z5))


def _cyc_exp_by_x(f):
    """f^|x| by cyclotomic square-and-multiply, then conjugate (x < 0)."""
    acc = FQ12_ONE
    started = False
    for i in range(BLS_X.bit_length() - 1, -1, -1):
        if started:
            acc = fq12_cyc_sqr(acc)
        if (BLS_X >> i) & 1:
            if started:
                acc = fq12_mul(acc, f)
            else:
                acc = f
                started = True
    return fq12_conj(acc) if BLS_X_IS_NEG else acc


def final_exponentiation(f) -> tuple:
    """f^((q^12-1)/r) with the structured BLS12-381 exponentiation:
    easy part (conjugate/inverse/Frobenius^2), then the x-chain hard part
    with cyclotomic squarings (Aranha et al. addition chain)."""
    # easy: f <- f^((q^6-1)(q^2+1))
    t0 = fq12_conj(f)
    t1 = fq12_inv(f)
    t2 = fq12_mul(t0, t1)
    t1 = t2
    t2 = fq12_mul(fq12_frob2(t2), t1)
    # hard part on t2 (now in the cyclotomic subgroup)
    t1 = fq12_conj(fq12_cyc_sqr(t2))
    t3 = _cyc_exp_by_x(t2)
    t4 = fq12_cyc_sqr(t3)
    t5 = fq12_mul(t1, t3)
    t1 = _cyc_exp_by_x(t5)
    t0 = _cyc_exp_by_x(t1)
    t6 = _cyc_exp_by_x(t0)
    t6 = fq12_mul(t6, t4)
    t4 = _cyc_exp_by_x(t6)
    t5 = fq12_conj(t5)
    t4 = fq12_mul(t4, fq12_mul(t5, t2))
    t5 = fq12_conj(t2)
    t1 = fq12_mul(t1, t2)
    t1 = fq12_frob(fq12_frob(fq12_frob(t1)))
    t6 = fq12_mul(t6, t5)
    t6 = fq12_frob(t6)
    t3 = fq12_mul(t3, t0)
    t3 = fq12_frob2(t3)
    t3 = fq12_mul(t3, t1)
    t3 = fq12_mul(t3, t6)
    return fq12_mul(t3, t4)


# --- sparse Fq12 multiplication by a line (c0 + c1 v + c4 v w) -------------


def _fq6_mul_by_01(a, b0, b1):
    """(a0,a1,a2) * (b0 + b1 v)."""
    a0, a1, a2 = a
    aa = fq2_mul(a0, b0)
    bb = fq2_mul(a1, b1)
    c0 = fq2_add(_mul_xi(fq2_mul(a2, b1)), aa)
    c1 = fq2_sub(fq2_sub(fq2_mul(fq2_add(b0, b1), fq2_add(a0, a1)), aa), bb)
    c2 = fq2_add(fq2_mul(a2, b0), bb)
    return (c0, c1, c2)


def _fq6_mul_by_1(a, b1):
    """(a0,a1,a2) * (b1 v)."""
    return (_mul_xi(fq2_mul(a[2], b1)), fq2_mul(a[0], b1), fq2_mul(a[1], b1))


def fq12_mul_by_014(f, c0, c1, c4):
    """f * (c0 + c1 v + c4 v w) — the sparsity pattern of an ate line."""
    f0, f1 = f
    aa = _fq6_mul_by_01(f0, c0, c1)
    bb = _fq6_mul_by_1(f1, c4)
    o = fq2_add(c1, c4)
    r1 = _fq6_mul_by_01(fq6_add(f1, f0), c0, o)
    r1 = fq6_sub(fq6_sub(r1, aa), bb)
    r0 = fq6_add(_fq6_mul_v(bb), aa)
    return (r0, r1)


# --- twist-resident Miller loop (Jacobian coords on E'(Fq2)) ----------------


def _dbl_step(rx, ry, rz):
    """Jacobian doubling of R on the twist + line coefficients
    (eprint 2010/354 Alg. 26 adaptation). Returns (rx,ry,rz,(t0,t3,t6))."""
    tmp0 = fq2_sqr(rx)
    tmp1 = fq2_sqr(ry)
    tmp2 = fq2_sqr(tmp1)
    tmp3 = fq2_sub(fq2_sub(fq2_sqr(fq2_add(tmp1, rx)), tmp0), tmp2)
    tmp3 = fq2_add(tmp3, tmp3)
    tmp4 = fq2_add(fq2_add(tmp0, tmp0), tmp0)
    tmp6 = fq2_add(rx, tmp4)
    tmp5 = fq2_sqr(tmp4)
    zsq = fq2_sqr(rz)
    nx = fq2_sub(fq2_sub(tmp5, tmp3), tmp3)
    nz = fq2_sub(fq2_sub(fq2_sqr(fq2_add(rz, ry)), tmp1), zsq)
    ny = fq2_mul(fq2_sub(tmp3, nx), tmp4)
    t2_8 = fq2_add(tmp2, tmp2)
    t2_8 = fq2_add(t2_8, t2_8)
    t2_8 = fq2_add(t2_8, t2_8)
    ny = fq2_sub(ny, t2_8)
    tmp3 = fq2_mul(tmp4, zsq)
    tmp3 = fq2_add(tmp3, tmp3)
    tmp3 = fq2_neg(tmp3)
    tmp6 = fq2_sub(fq2_sub(fq2_sqr(tmp6), tmp0), tmp5)
    t1_4 = fq2_add(tmp1, tmp1)
    t1_4 = fq2_add(t1_4, t1_4)
    tmp6 = fq2_sub(tmp6, t1_4)
    tmp0 = fq2_mul(nz, zsq)
    tmp0 = fq2_add(tmp0, tmp0)
    return nx, ny, nz, (tmp0, tmp3, tmp6)


def _add_step(rx, ry, rz, qx, qy):
    """Mixed Jacobian+affine addition R+Q on the twist + line coefficients
    (eprint 2010/354 Alg. 27 adaptation)."""
    zsq = fq2_sqr(rz)
    ysq = fq2_sqr(qy)
    t0 = fq2_mul(zsq, qx)
    t1 = fq2_mul(fq2_sub(fq2_sub(fq2_sqr(fq2_add(qy, rz)), ysq), zsq), zsq)
    t2 = fq2_sub(t0, rx)
    t3 = fq2_sqr(t2)
    t4 = fq2_add(t3, t3)
    t4 = fq2_add(t4, t4)
    t5 = fq2_mul(t4, t2)
    t6 = fq2_sub(fq2_sub(t1, ry), ry)
    t9 = fq2_mul(t6, qx)
    t7 = fq2_mul(t4, rx)
    nx = fq2_sub(fq2_sub(fq2_sub(fq2_sqr(t6), t5), t7), t7)
    nz = fq2_sub(fq2_sub(fq2_sqr(fq2_add(rz, t2)), zsq), t3)
    t10 = fq2_add(qy, nz)
    t8 = fq2_mul(fq2_sub(t7, nx), t6)
    t0 = fq2_mul(ry, t5)
    t0 = fq2_add(t0, t0)
    ny = fq2_sub(t8, t0)
    t10 = fq2_sub(fq2_sqr(t10), ysq)
    t10 = fq2_sub(t10, fq2_sqr(nz))
    t9 = fq2_sub(fq2_add(t9, t9), t10)
    t10 = fq2_add(nz, nz)
    t6 = fq2_neg(t6)
    t1 = fq2_add(t6, t6)
    return nx, ny, nz, (t10, t1, t9)


def _ell(f, coeffs, xp, yp):
    """Multiply f by the line, with the G1 coordinates folded into the
    Fq2 line coefficients (so the whole step stays sparse)."""
    c0, c1, c2 = coeffs
    c0 = fq2_scalar(c0, yp)
    c1 = fq2_scalar(c1, xp)
    return fq12_mul_by_014(f, c2, c1, c0)


def miller_loop(p, q) -> tuple:
    """Optimal ate Miller loop, twist-resident: R stays on E'(Fq2) in
    Jacobian coordinates, lines are sparse (014) Fq12 products. ~10x the
    generic untwisted loop (no Fq12 inversions)."""
    if p is None or q is None:
        return FQ12_ONE
    xp, yp = p
    qx, qy = q
    rx, ry, rz = qx, qy, FQ2_ONE
    f = FQ12_ONE
    for bit in bin(BLS_X)[3:]:
        f = fq12_sqr(f)
        rx, ry, rz, coeffs = _dbl_step(rx, ry, rz)
        f = _ell(f, coeffs, xp, yp)
        if bit == "1":
            rx, ry, rz, coeffs = _add_step(rx, ry, rz, qx, qy)
            f = _ell(f, coeffs, xp, yp)
    if BLS_X_IS_NEG:
        f = fq12_conj(f)
    return f


def pairing(p, q) -> tuple:
    """Full optimal ate pairing e(P, Q) -> Fq12 (GT). None inputs -> 1."""
    return final_exponentiation(miller_loop(p, q))


def pairing_generic(p, q) -> tuple:
    """Slow-oracle pairing (generic Miller + generic final exp)."""
    return final_exponentiation_generic(miller_loop_generic(p, q))


def pairing_product(pairs) -> tuple:
    """prod e(P_i, Q_i): shared final exponentiation over the Miller products.

    This is how pcV's 3-pairing check should be evaluated (one final exp
    instead of three)."""
    f = FQ12_ONE
    for p, q in pairs:
        f = fq12_mul(f, miller_loop(p, q))
    return final_exponentiation(f)


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the shape of every pcV check. Dispatches to
    the native C++ library when built (sonic_tpu/native.py), else Python."""
    from ..native import pairing_product_is_one_native

    native = pairing_product_is_one_native(pairs)
    if native is not None:
        return native
    return pairing_product(pairs) == FQ12_ONE
