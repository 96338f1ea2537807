"""Helper protocol, "signatures of correct computation": device prover and
host verifier.

Port of `sonic_tpu/signature.py` (hsc_prove, hsc_prove_device =
hsc_sj_device + hsc_cu_device, hsc_assemble, hsc_checks, hsc_verify).
Reference: src/Sonic/Signature.hs.
The m (y_j, z_j) openings are independent and shape-identical
(Signature.hs:40-57), so the helper runs as one batched s(X, y_j) build,
one batched commit and three batched opening MSMs, over slices of the m
instances within the step budget (`_instance_slices`; one slice at
n <= 2^16, 16 slices of 4 at n = 2^20, q = 64, where the 64 s(X, y_j)
alone would take 25.8 GB).
"""
from __future__ import annotations

import collections

import torch

from . import budget
from . import golden_protocol as gp
from .commitment import (
    commit_poly,
    commit_poly_batched,
    msms_to_host,
    open_poly,
    open_poly_batched,
    pcv_batch,
)
from .constraints import DeviceCircuit, s_at_u_of_y, s_at_y, s_at_y_batched
from .curve.group import cat
from .fields.limb import FR
from .msm.pippenger import WindowTotals
from .poly.laurent import evaluate
from .srs import SRS
from .utils.trace import span

# (m, n, slices of the m instances) -> calls of hsc_prove_device;
# breakdown's phase tables read it
slicings: collections.Counter = collections.Counter()


def _instance_slices(m: int, n: int) -> list:
    """[lo, hi) ranges of the helper's m instances, as even as the step
    budget allows: an instance holds 3n + 1 coefficients at
    `budget.INSTANCE_BYTES` a coefficient; at least one a slice."""
    k = -(-m // budget.per_step(budget.INSTANCE_BYTES * (3 * n + 1)))
    return [(m * i // k, m * (i + 1) // k) for i in range(k)]


def _cat_windows(parts: list) -> WindowTotals:
    """Slices of one kind of batched MSM, in order -> one WindowTotals."""
    if len(parts) == 1:
        return parts[0]
    return WindowTotals(cat([p.totals for p in parts]), parts[0].c, parts[0].group)


@span("sonic.protocol.helper")
def hsc_prove_device(srs: SRS, circuit: DeviceCircuit, ys, zs, u_m, v_m, mesh=None):
    """Device compute of hscProve (Signature.hs:32-72). ys, zs: (m, L)
    Montgomery challenge stacks, m >= 1. Returns (cms, ws, w2, qs, c, qv
    [MSMs before their window combine, pippenger.WindowTotals], fzs, s2
    [(m, L) Montgomery evaluations]).

    s(u, Y) is built, committed and opened at v once; then each slice of
    the instances (`_instance_slices`) builds its s(X, y_j), commits and
    opens them and opens s(u, Y) at its y_j, keeps only its MSMs' window
    totals and its evaluations, and frees the rest before the next slice.
    The slices' totals are concatenated in order, so the window combine
    sees the uncut layout.

    check_hole=False on the commits: s(X, y)'s X^0 coefficient and s(u,
    Y)'s Y^0 coefficient are zero by construction (Constraints.hs:34-53),
    so the reference's g^alpha panic cannot trigger here. With `mesh`,
    every MSM shards its points over the ranks."""
    n, m = circuit.n, ys.shape[0]
    su_y = s_at_u_of_y(circuit, u_m)
    c = commit_poly(srs, srs.d, su_y, check_hole=False, mesh=mesh)
    _, qv = open_poly(srs, v_m, su_y, mesh)
    cut = _instance_slices(m, n)
    slicings[(m, n, len(cut))] += 1
    parts = []
    for lo, hi in cut:
        s_coeffs, cms, fzs, ws = hsc_sj_device(srs, circuit, ys[lo:hi], zs[lo:hi], mesh)
        w2, s2, qs = _hsc_u_openings(srs, n, s_coeffs, su_y, u_m, ys[lo:hi], mesh)
        del s_coeffs
        parts.append((cms, ws, w2, qs, fzs, s2))
    cms, ws, w2, qs = (_cat_windows([p[k] for p in parts]) for k in range(4))
    fzs, s2 = (torch.cat([p[k] for p in parts]) for k in (4, 5))
    return cms, ws, w2, qs, c, qv, fzs, s2


def hsc_sj_device(srs: SRS, circuit: DeviceCircuit, ys, zs, mesh=None):
    """The S_j block of hscProve (Signature.hs:40-47): batched s(X, y_j)
    builds, batched commit, batched opening at z_j."""
    n = circuit.n
    with span("sonic.poly.s_yj"):
        s_coeffs = s_at_y_batched(circuit, ys)  # (m, 3n+1, L)
    cms = commit_poly_batched(srs, srs.d, -n, s_coeffs, check_hole=False, mesh=mesh)
    fzs, ws = open_poly_batched(srs, zs, -n, s_coeffs, mesh)
    return s_coeffs, cms, fzs, ws


def hsc_cu_device(srs: SRS, circuit: DeviceCircuit, s_coeffs, u_m, ys, v_m,
                  su_y=None, c=None, mesh=None):
    """The C/u/v block of hscProve (Signature.hs:48-63): commit s(u, Y),
    open the s(X, y_j) batch at u, open s(u, Y) at each y_j and at v.
    su_y / c may be passed in when already computed (the Fiat-Shamir
    prover must commit C and squeeze v before this block can run)."""
    if su_y is None:
        su_y = s_at_u_of_y(circuit, u_m)
    if c is None:
        c = commit_poly(srs, srs.d, su_y, check_hole=False, mesh=mesh)
    w2, s2, qs = _hsc_u_openings(srs, circuit.n, s_coeffs, su_y, u_m, ys, mesh)
    _, qv = open_poly(srs, v_m, su_y, mesh)
    return c, w2, s2, qs, qv


def _hsc_u_openings(srs: SRS, n: int, s_coeffs, su_y, u_m, ys, mesh):
    """The s(X, y_j) batch (offset -n) opened at u, and s(u, Y) opened at
    each y_j: (w2, s2, qs)."""
    m = ys.shape[0]
    _, w2 = open_poly_batched(srs, u_m.expand(ys.shape), -n, s_coeffs, mesh)
    su_b = su_y.coeffs.unsqueeze(0).expand((m,) + su_y.coeffs.shape)
    s2, qs = open_poly_batched(srs, ys, su_y.offset, su_b, mesh)
    return w2, s2, qs


def hsc_prove(srs: SRS, circuit: DeviceCircuit, yzs_m, u_m, v_m, mesh=None) -> gp.HscProof:
    """hscProve (Signature.hs:32-72). yzs_m: list of (y, z) Montgomery limb
    pairs; u_m, v_m: Montgomery limbs. Returns a host-form HscProof.

    All device work runs first, then the 4m+2 MSMs finish in one window
    combine, and the points come back in ONE batched to_affine and fetch,
    the 2m evaluations in one more. With `mesh`, every rank calls it with
    the same inputs and gets the same proof."""
    m = len(yzs_m)
    if m == 0:
        su_y = s_at_u_of_y(circuit, u_m)
        c = commit_poly(srs, srs.d, su_y, mesh=mesh)
        _, qv = open_poly(srs, v_m, su_y, mesh)
        c_h, qv_h = msms_to_host([c, qv])
        return gp.HscProof(
            hsc_s=[], hsc_w=[], hsc_qv=qv_h, hsc_c=c_h,
            hsc_u=int(FR.to_int(u_m)), hsc_v=int(FR.to_int(v_m)),
        )
    ys = torch.stack([y for y, _ in yzs_m])  # (m, L)
    zs = torch.stack([z for _, z in yzs_m])
    cms, ws, w2, qs, c, qv, fzs, s2 = hsc_prove_device(srs, circuit, ys, zs, u_m, v_m, mesh)
    pts = msms_to_host([cms, ws, w2, qs, c, qv])
    evs = [int(v) for v in FR.to_int(torch.cat([fzs, s2], 0))]
    cms_h, ws_h = pts[:m], pts[m : 2 * m]
    w2_h, qs_h = pts[2 * m : 3 * m], pts[3 * m : 4 * m]
    c_h, qv_h = pts[4 * m], pts[4 * m + 1]
    fzs_i, s2_i = evs[:m], evs[m:]
    return gp.HscProof(
        hsc_s=[(cms_h[j], (fzs_i[j], ws_h[j])) for j in range(m)],
        hsc_w=[(s2_i[j], w2_h[j], qs_h[j]) for j in range(m)],
        hsc_qv=qv_h,
        hsc_c=c_h,
        hsc_u=int(FR.to_int(u_m)),
        hsc_v=int(FR.to_int(v_m)),
    )


def hsc_assemble(B: int, m: int, c_list, qv_list, cms, fzs, ws, s2, w2, qs, us, vs) -> list:
    """Reassemble per-proof HscProofs from the flat (B*m) batched pipeline
    outputs of prove_batch (same field layout as hsc_prove)."""
    out = []
    for b in range(B):
        sl = range(b * m, (b + 1) * m)
        out.append(
            gp.HscProof(
                hsc_s=[(cms[i], (fzs[i], ws[i])) for i in sl],
                hsc_w=[(s2[i], w2[i], qs[i]) for i in sl],
                hsc_qv=qv_list[b],
                hsc_c=c_list[b],
                hsc_u=us[b],
                hsc_v=vs[b],
            )
        )
    return out


def hsc_checks(srs: SRS, circuit: DeviceCircuit, yzs, proof: gp.HscProof) -> list:
    """The 3m+1 pcV checks of hscVerify (Signature.hs:74-90) as
    (maxm, F, z, v, W) tuples; s(u, v) recomputed on the device."""
    dev = circuit.device
    v_m = FR.from_int(proof.hsc_v, device=dev)
    u_m = FR.from_int(proof.hsc_u, device=dev)
    sv = FR.to_int(evaluate(s_at_y(circuit, v_m), u_m))
    checks = [(srs.d, proof.hsc_c, proof.hsc_v, sv, proof.hsc_qv)]
    for (yi, zi), (ci, (si, wi)), (si2, wi2, qi) in zip(
        yzs, proof.hsc_s, proof.hsc_w
    ):
        checks.append((srs.d, ci, zi, si, wi))
        checks.append((srs.d, ci, proof.hsc_u, si2, wi2))
        checks.append((srs.d, proof.hsc_c, yi, si2, qi))
    return checks


def hsc_verify(srs: SRS, circuit: DeviceCircuit, yzs, proof: gp.HscProof) -> bool:
    """hscVerify (Signature.hs:74-90): one batched random-linear-combination
    pairing product over the 3m+1 pcV checks (commitment.pcv_batch)."""
    return pcv_batch(srs, hsc_checks(srs, circuit, yzs, proof))
