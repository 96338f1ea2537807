"""JAX-free copy of `sonic_tpu/golden_protocol.py`. Below this docstring the code is
the original's, line for line; its relative imports resolve inside the port.

`sonic_tpu/__init__.py` imports jax whenever any of its submodules is
imported, so the port carries its own copy of this host module.
ROADMAP item 16 (a lazy `sonic_tpu/__init__`) removes the copy.

Original docstring:

Host-side golden Sonic protocol: exact, slow, Python-int implementation.

This mirrors the reference's semantics module-for-module (Constraints /
CommitmentScheme / SRS / Signature / Protocol — SURVEY.md §§1-3) and serves
as (a) the oracle the TPU path must match bit-exactly for identical
randomness, and (b) the generator of golden test vectors. Polynomials are
SPARSE dicts exactly like the reference's Data.Poly.Sparse.Laurent terms
(zero coefficients dropped), so index-range panics happen in precisely the
same situations (e.g. the missing g^alpha slot, SRS.hs:38-39).

Univariate Laurent: {exp: coeff}   (ints mod r, zeros dropped)
Bivariate:          {xexp: {yexp: coeff}}   (X outer, Y inner — matching
                    BiVLaurent k = VLaurent (VLaurent k), Utils.hs:15)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .fields.constants import R_MOD
from . import golden as gc
from .pairing import host as pr
from .circuit import ArithCircuit, Assignment, GateWeights

P = R_MOD  # scalar field modulus

# ---------------------------------------------------------------------------
# Sparse Laurent polynomial helpers
# ---------------------------------------------------------------------------


def lp_norm(f: dict) -> dict:
    return {e: c % P for e, c in f.items() if c % P != 0}


def lp_add(f: dict, g: dict) -> dict:
    out = dict(f)
    for e, c in g.items():
        out[e] = (out.get(e, 0) + c) % P
    return lp_norm(out)


def lp_scale(f: dict, c: int) -> dict:
    return lp_norm({e: v * c % P for e, v in f.items()})


def lp_mul(f: dict, g: dict) -> dict:
    out: dict = {}
    for e1, c1 in f.items():
        for e2, c2 in g.items():
            e = e1 + e2
            out[e] = (out.get(e, 0) + c1 * c2) % P
    return lp_norm(out)


def lp_eval(f: dict, z: int) -> int:
    acc = 0
    zinv = None
    for e, c in f.items():
        if e >= 0:
            acc += c * pow(z, e, P)
        else:
            if zinv is None:
                zinv = pow(z, -1, P)
            acc += c * pow(zinv, -e, P)
    return acc % P


def lp_div_linear(f: dict, z: int) -> dict:
    """(f(X) - f(z)) / (X - z): exact Laurent division via dense synthetic
    division on X^(-lo) (f - f(z)) (mirrors Data.Euclidean.divide use at
    CommitmentScheme.hs:44)."""
    fz = lp_eval(f, z)
    g = lp_add(f, {0: -fz % P})
    if not g:
        return {}
    lo = min(g)
    hi = max(g)
    dense = [g.get(e, 0) for e in range(lo, hi + 1)]
    # synthetic division of sum dense[i] X^i (i from 0) by (X - z)
    w = [0] * (len(dense) - 1)
    carry = 0
    for i in range(len(dense) - 1, 0, -1):
        carry = (dense[i] + z * carry) % P
        w[i - 1] = carry
    rem = (dense[0] + z * carry) % P
    assert rem == 0, "division not exact"
    return lp_norm({lo + i: c for i, c in enumerate(w)})


# Bivariate ------------------------------------------------------------------


def bp_norm(f: dict) -> dict:
    out = {}
    for xe, yp in f.items():
        ypn = lp_norm(yp)
        if ypn:
            out[xe] = ypn
    return out


def bp_add(f: dict, g: dict) -> dict:
    out = {xe: dict(yp) for xe, yp in f.items()}
    for xe, yp in g.items():
        out[xe] = lp_add(out.get(xe, {}), yp)
    return bp_norm(out)


def bp_mul(f: dict, g: dict) -> dict:
    out: dict = {}
    for xe1, yp1 in f.items():
        for xe2, yp2 in g.items():
            xe = xe1 + xe2
            out[xe] = lp_add(out.get(xe, {}), lp_mul(yp1, yp2))
    return bp_norm(out)


def bp_eval_y(y: int, f: dict) -> dict:
    """Substitute the inner variable Y -> univariate in X (Utils.hs:20-21)."""
    return lp_norm({xe: lp_eval(yp, y) for xe, yp in f.items()})


def bp_eval_x(x: int, f: dict) -> dict:
    """Substitute the outer variable X -> univariate in Y (Utils.hs:17-18)."""
    out: dict = {}
    xinv = pow(x, -1, P) if any(e < 0 for e in f) else None
    for xe, yp in f.items():
        c = pow(x, xe, P) if xe >= 0 else pow(xinv, -xe, P)
        out = lp_add(out, lp_scale(yp, c))
    return out


def bp_from_x(f: dict) -> dict:
    """Embed univariate-in-X as bivariate (Y-degree 0) (Utils.hs:23-24)."""
    return {xe: {0: c} for xe, c in f.items()}


def bp_from_y(f: dict) -> dict:
    """Embed univariate-in-Y as bivariate at X^0 (Utils.hs:26-27)."""
    return {0: dict(f)} if f else {}


# ---------------------------------------------------------------------------
# Constraints -> polynomials (Constraints.hs)
# ---------------------------------------------------------------------------


def r_poly(assignment: Assignment) -> dict:
    """r(X,Y) = sum_i a_i X^i Y^i + b_i X^-i Y^-i + c_i X^-(i+n) Y^-(i+n)
    (Constraints.hs:23-31)."""
    n = assignment.n
    out: dict = {}
    for idx in range(1, n + 1):
        a, b, c = (
            assignment.aL[idx - 1],
            assignment.aR[idx - 1],
            assignment.aO[idx - 1],
        )
        out[idx] = {idx: a % P}
        out[-idx] = {-idx: b % P}
        out[-idx - n] = {-idx - n: c % P}
    return bp_norm(out)


def s_poly(weights: GateWeights) -> dict:
    """s(X,Y) = sum_i u_i(Y) X^-i + v_i(Y) X^i + w_i(Y) X^(i+n)
    (Constraints.hs:34-53)."""
    n = weights.n
    out: dict = {}
    for i in range(1, n + 1):
        ui = {q + 1 + n: weights.wL[q][i - 1] % P for q in range(weights.q)}
        vi = {q + 1 + n: weights.wR[q][i - 1] % P for q in range(weights.q)}
        wi = lp_add(
            {i: -1 % P, -i: -1 % P},
            {q + 1 + n: weights.wO[q][i - 1] % P for q in range(weights.q)},
        )
        out[-i] = lp_add(out.get(-i, {}), ui)
        out[i] = lp_add(out.get(i, {}), vi)
        out[i + n] = lp_add(out.get(i + n, {}), wi)
    return bp_norm(out)


def k_poly(cs: Sequence[int], n: int) -> dict:
    """k(Y) = sum_q cs_q Y^(n+q) (Constraints.hs:67-68)."""
    return lp_norm({n + 1 + q: cs[q] % P for q in range(len(cs))})


def t_poly(r_xy: dict, s_xy: dict, k_y: dict) -> dict:
    """t(X,Y) = r(X,1) (r(X,Y) + s(X,Y)) - k(Y) (Constraints.hs:56-65)."""
    r_x1 = bp_from_x(bp_eval_y(1, r_xy))
    return bp_add(bp_mul(r_x1, bp_add(r_xy, s_xy)), bp_from_y(lp_scale(k_y, -1)))


# ---------------------------------------------------------------------------
# SRS (SRS.hs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SRS:
    d: int
    g_neg_x: list  # g^{x^-i}, i=1..d
    g_pos_x: list  # g^{x^i},  i=0..d
    h_neg_x: list
    h_pos_x: list
    g_neg_ax: list  # g^{alpha x^-i}, i=1..d
    g_pos_ax: list  # g^{alpha x^i},  i=1..d   (g^alpha deliberately omitted)
    h_neg_ax: list
    h_pos_ax: list  # h^{alpha x^i},  i=0..d

    @classmethod
    def new(cls, d: int, x: int, alpha: int) -> "SRS":
        xinv = pow(x, -1, P)
        g, h = gc.G1_GEN, gc.G2_GEN

        def tab(base, mul, base_scalar, exps):
            return [mul(base, base_scalar * e % P) for e in exps]

        pos = [pow(x, i, P) for i in range(0, d + 1)]
        neg = [pow(xinv, i, P) for i in range(1, d + 1)]
        return cls(
            d=d,
            g_neg_x=[gc.g1_mul(g, e) for e in neg],
            g_pos_x=[gc.g1_mul(g, e) for e in pos],
            h_neg_x=[gc.g2_mul(h, e) for e in neg],
            h_pos_x=[gc.g2_mul(h, e) for e in pos],
            g_neg_ax=[gc.g1_mul(g, alpha * e % P) for e in neg],
            g_pos_ax=[gc.g1_mul(g, alpha * e % P) for e in pos[1:]],
            h_neg_ax=[gc.g2_mul(h, alpha * e % P) for e in neg],
            h_pos_ax=[gc.g2_mul(h, alpha * e % P) for e in pos],
        )


# ---------------------------------------------------------------------------
# Commitment scheme (CommitmentScheme.hs)
# ---------------------------------------------------------------------------


def commit_poly(srs: SRS, maxm: int, f_x: dict):
    """Commit(info, f(X)) -> F (CommitmentScheme.hs:20-33)."""
    diff = srs.d - maxm
    xf = lp_mul({diff: 1}, f_x)
    acc = None
    for e, v in xf.items():
        if e > 0:
            tab, idx = srs.g_pos_ax, e - 1
        else:
            tab, idx = srs.g_neg_ax, abs(e) - 1
        if idx < 0 or idx >= len(tab):
            raise IndexError(
                f"commitPoly: SRS table not long enough: {idx} >= {len(tab)}"
            )
        acc = gc.g1_add(acc, gc.g1_mul(tab[idx], v))
    return acc


def open_poly(srs: SRS, z: int, f_x: dict):
    """Open(info, F, z, f(X)) -> (f(z), W) (CommitmentScheme.hs:36-48)."""
    fz = lp_eval(f_x, z)
    w_poly = lp_div_linear(f_x, z)
    acc = None
    for e, v in w_poly.items():
        if e >= 0:
            tab, idx = srs.g_pos_x, e
        else:
            tab, idx = srs.g_neg_x, abs(e) - 1
        if idx >= len(tab):
            raise IndexError(
                f"openPoly: SRS table not long enough: {idx} >= {len(tab)}"
            )
        acc = gc.g1_add(acc, gc.g1_mul(tab[idx], v))
    return fz, acc


def pcv(srs: SRS, maxm: int, commitment, z: int, v_w) -> bool:
    """pcV(info, F, z, (v, W)) (CommitmentScheme.hs:51-68): checks
    e(W, h^{alpha x}) e(g^v W^{-z}, h^alpha) == e(F, h^{x^{-d+max}})."""
    v, w = v_w
    diff = -srs.d + maxm
    if diff >= 0:
        hxi = srs.h_pos_x[diff]
    else:
        hxi = srs.h_neg_x[abs(diff) - 1]
    gv_wz = gc.g1_add(gc.g1_mul(gc.G1_GEN, v), gc.g1_mul(w, -z % P))
    # product form with one shared final exponentiation:
    # e(W, h^{ax}) e(g^v W^{-z}, h^a) e(-F, hxi) == 1
    return pr.pairing_product_is_one(
        [
            (w, srs.h_pos_ax[1]),
            (gv_wz, srs.h_pos_ax[0]),
            (gc.g1_neg(commitment), hxi),
        ]
    )


# ---------------------------------------------------------------------------
# Helper protocol (Signature.hs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HscProof:
    hsc_s: list  # [(S_j, (s_j, W_j))]
    hsc_w: list  # [(s'_j, W'_j, Q_j)]
    hsc_qv: object
    hsc_c: object
    hsc_u: int
    hsc_v: int


def hsc_prove(srs: SRS, s_xy: dict, yzs, u: int, v: int) -> HscProof:
    """hscProve (Signature.hs:32-72); u, v supplied by the random oracle."""
    ss = []
    for yi, zi in yzs:
        s_xy_at_y = bp_eval_y(yi, s_xy)
        cm = commit_poly(srs, srs.d, s_xy_at_y)
        op = open_poly(srs, zi, s_xy_at_y)
        ss.append((cm, op))
    su_y = bp_eval_x(u, s_xy)  # s(u, Y)
    c = commit_poly(srs, srs.d, su_y)
    sw = []
    for yi, _zi in yzs:
        _, wj2 = open_poly(srs, u, bp_eval_y(yi, s_xy))
        sj2, qj = open_poly(srs, yi, su_y)
        sw.append((sj2, wj2, qj))
    _, qv = open_poly(srs, v, su_y)
    return HscProof(ss, sw, qv, c, u, v)


def hsc_verify(srs: SRS, s_xy: dict, yzs, proof: HscProof) -> bool:
    """hscVerify (Signature.hs:74-90): 3m+1 pcV checks."""
    sv = lp_eval(bp_eval_y(proof.hsc_v, s_xy), proof.hsc_u)
    ok = pcv(srs, srs.d, proof.hsc_c, proof.hsc_v, (sv, proof.hsc_qv))
    for (yi, zi), (ci, (si, wi)), (si2, wi2, qi) in zip(
        yzs, proof.hsc_s, proof.hsc_w
    ):
        ok = ok and pcv(srs, srs.d, ci, zi, (si, wi))
        ok = ok and pcv(srs, srs.d, ci, proof.hsc_u, (si2, wi2))
        ok = ok and pcv(srs, srs.d, proof.hsc_c, yi, (si2, qi))
    return ok


# ---------------------------------------------------------------------------
# Protocol (Protocol.hs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Proof:
    pr_r: object
    pr_t: object
    pr_a: int
    pr_wa: object
    pr_b: int
    pr_wb: object
    pr_wt: object
    pr_s: int
    pr_hsc: HscProof


@dataclasses.dataclass
class RndOracle:
    """Random-oracle values, kept for the verifier (Protocol.hs:41-45)."""

    y: int
    z: int
    yzs: list


@dataclasses.dataclass
class Randomness:
    """All prover-side randomness made explicit, so runs are reproducible
    and the TPU path can be checked bit-exactly against this one."""

    cns: list  # 4 blinding scalars c_{n+1..n+4}
    y: int
    z: int
    ys: list  # m helper challenges
    zs: list
    u: int
    v: int

    @classmethod
    def generate(cls, rng, m: int) -> "Randomness":
        r = lambda: rng.randrange(1, P)
        return cls(
            cns=[r() for _ in range(4)],
            y=r(),
            z=r(),
            ys=[r() for _ in range(m)],
            zs=[r() for _ in range(m)],
            u=r(),
            v=r(),
        )


def prove(
    srs: SRS, assignment: Assignment, circuit: ArithCircuit, rnd: Randomness
):
    """Protocol.hs:47-109 with explicit randomness."""
    n = assignment.n
    m = circuit.weights.q
    if srs.d < 7 * n:
        raise ValueError(
            f"Parameter d is not large enough: {srs.d} should be > {7 * n}"
        )
    # zkP_1: blind and commit r
    sumc = {
        -(2 * n + i): {-(2 * n + i): rnd.cns[i - 1] % P} for i in range(1, 5)
    }
    poly_r1 = bp_add(r_poly(assignment), sumc)
    r_x1 = bp_eval_y(1, poly_r1)
    commit_r = commit_poly(srs, n, r_x1)

    # zkV_1 -> y ; zkP_2: commit t
    k_y = k_poly(circuit.cs, n)
    s_xy = s_poly(circuit.weights)
    t_xy = t_poly(poly_r1, s_xy, k_y)
    t_xy_at_y = bp_eval_y(rnd.y, t_xy)
    commit_t = commit_poly(srs, srs.d, t_xy_at_y)

    # zkV_2 -> z ; zkP_3: openings
    a, wa = open_poly(srs, rnd.z, r_x1)
    b, wb = open_poly(srs, rnd.y * rnd.z % P, r_x1)
    _, wt = open_poly(srs, rnd.z, t_xy_at_y)
    szy = lp_eval(bp_eval_y(rnd.y, s_xy), rnd.z)

    yzs = list(zip(rnd.ys, rnd.zs))
    hsc = hsc_prove(srs, s_xy, yzs, rnd.u, rnd.v)
    proof = Proof(commit_r, commit_t, a, wa, b, wb, wt, szy, hsc)
    return proof, RndOracle(rnd.y, rnd.z, yzs)


def verify(
    srs: SRS,
    circuit: ArithCircuit,
    proof: Proof,
    y: int,
    z: int,
    yzs: list,
) -> bool:
    """Protocol.hs:111-130."""
    n = circuit.weights.n
    k_y = k_poly(circuit.cs, n)
    s_xy = s_poly(circuit.weights)
    t = (proof.pr_a * ((proof.pr_b + proof.pr_s) % P) - lp_eval(k_y, y)) % P
    return (
        hsc_verify(srs, s_xy, yzs, proof.pr_hsc)
        and pcv(srs, n, proof.pr_r, z, (proof.pr_a, proof.pr_wa))
        and pcv(srs, n, proof.pr_r, y * z % P, (proof.pr_b, proof.pr_wb))
        and pcv(srs, srs.d, proof.pr_t, z, (t, proof.pr_wt))
    )
