"""Helper protocol, "signatures of correct computation": device prover and
host verifier.

Port of `sonic_tpu/signature.py` (hsc_prove_device = hsc_sj_device +
hsc_cu_device, hsc_checks, hsc_verify). Reference: src/Sonic/Signature.hs.
The m (y_j, z_j) openings are independent and shape-identical
(Signature.hs:40-57), so the helper runs as one batched s(X, y_j) build,
one batched commit and three batched opening MSMs.
"""
from __future__ import annotations

from . import golden_protocol as gp
from .commitment import (
    commit_poly,
    commit_poly_batched,
    open_poly,
    open_poly_batched,
    pcv_batch,
)
from .constraints import DeviceCircuit, s_at_u_of_y, s_at_y, s_at_y_batched
from .fields.limb import FR
from .poly.laurent import evaluate
from .srs import SRS


def hsc_prove_device(srs: SRS, circuit: DeviceCircuit, ys, zs, u_m, v_m):
    """Device compute of hscProve (Signature.hs:32-72). ys, zs: (m, L)
    Montgomery challenge stacks, m >= 1. Returns (cms, ws, w2, qs, c, qv
    [MSMs before their window combine, pippenger.WindowTotals], fzs, s2
    [(m, L) Montgomery evaluations]).

    check_hole=False on the commits: s(X, y)'s X^0 coefficient and s(u,
    Y)'s Y^0 coefficient are zero by construction (Constraints.hs:34-53),
    so the reference's g^alpha panic cannot trigger here."""
    s_coeffs, cms, fzs, ws = hsc_sj_device(srs, circuit, ys, zs)
    c, w2, s2, qs, qv = hsc_cu_device(srs, circuit, s_coeffs, u_m, ys, v_m)
    return cms, ws, w2, qs, c, qv, fzs, s2


def hsc_sj_device(srs: SRS, circuit: DeviceCircuit, ys, zs):
    """The S_j block of hscProve (Signature.hs:40-47): batched s(X, y_j)
    builds, batched commit, batched opening at z_j."""
    n = circuit.n
    s_coeffs = s_at_y_batched(circuit, ys)  # (m, 3n+1, L)
    cms = commit_poly_batched(srs, srs.d, -n, s_coeffs, check_hole=False)
    fzs, ws = open_poly_batched(srs, zs, -n, s_coeffs)
    return s_coeffs, cms, fzs, ws


def hsc_cu_device(srs: SRS, circuit: DeviceCircuit, s_coeffs, u_m, ys, v_m):
    """The C/u/v block of hscProve (Signature.hs:48-63): commit s(u, Y),
    open the s(X, y_j) batch at u, open s(u, Y) at each y_j and at v."""
    n = circuit.n
    m = ys.shape[0]
    su_y = s_at_u_of_y(circuit, u_m)
    c = commit_poly(srs, srs.d, su_y, check_hole=False)
    _, w2 = open_poly_batched(srs, u_m.expand(ys.shape), -n, s_coeffs)
    su_b = su_y.coeffs.unsqueeze(0).expand((m,) + su_y.coeffs.shape)
    s2, qs = open_poly_batched(srs, ys, su_y.offset, su_b)
    _, qv = open_poly(srs, v_m, su_y)
    return c, w2, s2, qs, qv


def hsc_checks(srs: SRS, circuit: DeviceCircuit, yzs, proof: gp.HscProof) -> list:
    """The 3m+1 pcV checks of hscVerify (Signature.hs:74-90) as
    (maxm, F, z, v, W) tuples; s(u, v) recomputed on the device."""
    dev = circuit.wL.device
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
