"""Polynomial commitment scheme: device commit/open, host pairing check.

Port of `sonic_tpu/commitment.py`. Reference: src/Sonic/CommitmentScheme.hs.
The bounded-max-degree shift by X^(d-max) (:31-33) is an index offset into
the merged SRS tables, so every commit or opening is a table slice feeding
one Pippenger MSM. The device functions return their MSMs before the
window combine (`pippenger.WindowTotals`); the prover finishes all of a
proof's MSMs with one `pippenger.combine_windows`.

Reference conventions kept:
  - commit uses the alpha tables; the shifted polynomial must not have a
    nonzero X^0 coefficient (g^alpha is omitted from the SRS). A zero one
    is harmless (the e = 0 row is the point at infinity); a nonzero one
    raises IndexError, the reference's `index` panic (:70-73).
  - exponent-range overflows raise IndexError too.

`pcv` and `pcv_batch` are the JAX package's host code, unchanged apart
from imports.
"""
from __future__ import annotations

from . import golden as gc
from . import golden_protocol as gp
from .curve.group import Affine, Jacobian, g1
from .fields import limb
from .fields.limb import FQ, FR
from .msm.pippenger import WindowTotals, msm_windows
from .pairing import host as pr
from .poly.laurent import Laurent, div_by_linear, div_by_linear_batched
from .srs import SRS


def _slice_table(tab: Affine, start: int, length: int) -> Affine:
    s = slice(start, start + length)
    return Affine(tab.x[s], tab.y[s], tab.inf[s])


def _check_range(kind: str, srs: SRS, lo: int, hi: int):
    if lo < -srs.d or hi > srs.d:
        raise IndexError(f"{kind}: exponent range [{lo}, {hi}] outside SRS (d={srs.d})")


def _check_hole(c0):
    if not bool((c0 == 0).all()):
        raise IndexError(
            "commitPoly: nonzero coefficient at alpha*x^0 (g^alpha is "
            "not in the SRS)"
        )


def commit_poly(srs: SRS, maxm: int, f: Laurent, check_hole: bool = True,
                lanes: int | None = None) -> WindowTotals:
    """Commit(info, max, f(X)) -> F (CommitmentScheme.hs:20-33): MSM of f's
    coefficients against the g^(alpha x^(d-max+e)) rows."""
    lo = f.offset + srs.d - maxm  # lowest shifted exponent
    hi = lo + f.length - 1
    _check_range("commitPoly", srs, lo, hi)
    if check_hole and lo <= 0 <= hi:
        _check_hole(f.coeffs[-lo])
    pts = _slice_table(srs.g_ax, lo + srs.d, f.length)
    return msm_windows(pts, limb.from_mont(f.coeffs, FR), lanes=lanes)


def open_poly(srs: SRS, z, f: Laurent, lanes: int | None = None):
    """Open(info, F, z, f(X)) -> (f(z), W) (CommitmentScheme.hs:36-48).
    z: Fr element (Montgomery limbs). Returns (f(z) limbs, W)."""
    fz, w = div_by_linear(f, z)
    _check_range("openPoly", srs, w.offset, w.offset + w.length - 1)
    pts = _slice_table(srs.g_x, w.offset + srs.d, w.length)
    return fz, msm_windows(pts, limb.from_mont(w.coeffs, FR), lanes=lanes)


def commit_poly_batched(srs: SRS, maxm: int, offset: int, coeffs, check_hole: bool = True,
                        lanes: int | None = None) -> WindowTotals:
    """M commitments sharing one exponent span: coeffs (M, D, L) at a common
    `offset` -> a batch (M,), as ONE batched MSM over one table slice."""
    lo = offset + srs.d - maxm
    hi = lo + coeffs.shape[1] - 1
    _check_range("commitPoly", srs, lo, hi)
    if check_hole and lo <= 0 <= hi:
        _check_hole(coeffs[:, -lo])
    pts = _slice_table(srs.g_ax, lo + srs.d, coeffs.shape[1])
    return msm_windows(pts, limb.from_mont(coeffs, FR), lanes=lanes)


def open_poly_batched(srs: SRS, zs, offset: int, coeffs, lanes: int | None = None):
    """M openings sharing one exponent span: coeffs (M, D, L) at `offset`,
    zs (M, L) -> (fz (M, L), W batch (M,))."""
    fz, w = div_by_linear_batched(offset, coeffs, zs)
    _check_range("openPoly", srs, offset, offset + w.shape[1] - 1)
    pts = _slice_table(srs.g_x, offset + srs.d, w.shape[1])
    return fz, msm_windows(pts, limb.from_mont(w, FR), lanes=lanes)


def pcv(srs: SRS, maxm: int, commitment, z: int, v: int, w) -> bool:
    """pcV(info, max, F, z, (v, W)) — host pairing check
    (CommitmentScheme.hs:51-68). commitment/w: host G1 affine tuples;
    z, v: python ints."""
    diff = -srs.d + maxm
    hxi = srs.h_x_at(diff)
    h_a = srs.h_ax_at(0)
    h_ax = srs.h_ax_at(1)
    gv_wz = gc.g1_add(
        gc.g1_mul(gc.G1_GEN, v), gc.g1_mul(w, (-z) % gp.P)
    )
    return pr.pairing_product_is_one(
        [(w, h_ax), (gv_wz, h_a), (gc.g1_neg(commitment), hxi)]
    )


def _host_msm(points, scalars):
    """Host-side G1 MSM (native Pippenger when built, golden otherwise)."""
    from .native import g1_msm_native

    res = g1_msm_native(points, scalars)
    if res is not NotImplemented:
        return res
    return gc.g1_msm(points, scalars)


def pcv_batch(srs: SRS, checks) -> bool:
    """Verify a list of pcV checks (maxm, F, z, v, W) as ONE pairing product
    via random linear combination.

    Each check i is the reference's 3-pairing equation
    (CommitmentScheme.hs:58-68):
        e(W_i, h^{ax}) * e(g^{v_i} W_i^{-z_i}, h^a) * e(F_i^{-1}, h^{x^{-d+max_i}}) = 1.
    Raising check i to a fresh 128-bit rho_i and multiplying them out gives
        e(sum rho_i W_i, h^{ax})
      * e(g^{sum rho_i v_i} + sum -rho_i z_i W_i, h^a)
      * prod_{distinct max} e(-sum_{i in grp} rho_i F_i, h^{x^{-d+max}}) = 1,
    i.e. three host MSMs + ONE pairing product of 2 + #distinct-max pairs —
    instead of 3 pairings per check. Soundness error <= k * 2^-128 (a bad
    check survives only if the rho-combination cancels, Schwartz-Zippel on
    the verifier's own randomness). Set SONIC_TPU_NO_BATCH_PCV=1 to force
    the reference's check-by-check evaluation."""
    import os
    import secrets

    if not checks:
        return True
    if os.environ.get("SONIC_TPU_NO_BATCH_PCV"):
        return all(pcv(srs, *c) for c in checks)
    P = gp.P
    rhos = [secrets.randbits(128) | 1 for _ in checks]
    a_pts, a_sc = [], []
    b_pts, b_sc = [], []
    groups: dict = {}
    vsum = 0
    for rho, (maxm, F, z, v, w) in zip(rhos, checks):
        a_pts.append(w)
        a_sc.append(rho)
        b_pts.append(w)
        b_sc.append((-rho * z) % P)
        vsum = (vsum + rho * v) % P
        groups.setdefault(maxm, []).append((F, rho))
    b_pts.append(gc.G1_GEN)
    b_sc.append(vsum)
    A = _host_msm(a_pts, a_sc)
    B = _host_msm(b_pts, b_sc)
    pairs = [(A, srs.h_ax_at(1)), (B, srs.h_ax_at(0))]
    for maxm, items in groups.items():
        cm = _host_msm([f for f, _ in items], [r_ for _, r_ in items])
        pairs.append(
            (None if cm is None else gc.g1_neg(cm), srs.h_x_at(-srs.d + maxm))
        )
    return pr.pairing_product_is_one(pairs)


def jacobians_to_host(p: Jacobian) -> list:
    """Batched Jacobian (leading axis M) -> list of host affine tuples (None
    for infinity): ONE batched to_affine (one batch_inv) and one fetch."""
    aff = g1.to_affine(p)
    xs, ys = FQ.to_int(aff.x.reshape(-1, FQ.nlimbs)), FQ.to_int(aff.y.reshape(-1, FQ.nlimbs))
    infs = aff.inf.reshape(-1).tolist()
    return [None if infs[i] else (int(xs[i]), int(ys[i])) for i in range(len(infs))]
