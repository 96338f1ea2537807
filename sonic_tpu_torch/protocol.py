"""The Sonic protocol: device prover and hybrid verifier, in PyTorch.

Port of `sonic_tpu/protocol.py` (`prove` and `verify`; `prove_batch` waits,
see ROADMAP). Reference: src/Sonic/Protocol.hs, with the reference's
prover-supplied challenges (explicit `Randomness`, no Fiat-Shamir):

  zkP_1  r'(X,1) build + commit            -> build + MSM
  zkP_2  t(X,y) = r(X,1)(r(X,y)+s(X,y))-k(y) -> dense Laurent product + MSM
  zkP_3  three openings                    -> synthetic division + MSM
  helper hscProve                          -> batched builds + MSMs

The verifier recomputes s/k on the device and checks the pairings on the
host. Proofs come back in host (golden_protocol) form, so the golden, JAX
and PyTorch provers compare bit for bit.
"""
from __future__ import annotations

import torch

from . import golden_protocol as gp
from .commitment import commit_poly, jacobians_to_host, open_poly, pcv_batch
from .constraints import (
    DeviceAssignment,
    DeviceCircuit,
    k_at_y,
    r_at_y,
    r_x1_poly,
    s_at_u_of_y,
    s_at_y,
)
from .curve.group import Jacobian, cat
from .fields import limb
from .fields.limb import FR
from .msm.pippenger import combine_windows
from .poly import laurent
from .poly.laurent import Laurent, evaluate
from .signature import hsc_checks, hsc_prove_device
from .srs import SRS


def _prove_compute(srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m):
    """The prover's device compute (zkP_1..3 + helper), with no host reads.
    Returns (allj, scal): a (4m+7,) Jacobian stack [R, T, Wa, Wb, Wt,
    S_j*m, W_j*m, W'_j*m, Q_j*m, C, Qv] and a (2m+4, L) Montgomery scalar
    stack [a, b, s(z,y), t_const, s_j*m, s'_j*m].

    t_const is the t-commitment's g^alpha hole value (nonzero exactly when
    the assignment violates the constraints); `prove` checks it after the
    one batched fetch and raises the reference's panic. The phases return
    their MSMs before the window combine, which runs for all of them in
    one batched pass (pippenger.combine_windows)."""
    parts, scal = _prove_phases(
        srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m
    )
    return _stack_points(combine_windows(parts)), scal


def _prove_phases(srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m):
    n = assignment.n
    m = ys_st.shape[0]
    # zkP_1
    r1 = r_x1_poly(assignment, cns_m)
    commit_r = commit_poly(srs, n, r1)
    # zkP_2
    r_y = r_at_y(r1, y_m)
    s_y = s_at_y(circuit, y_m)
    k_y = k_at_y(circuit, n, y_m)
    t_y = laurent.mul(r1, laurent.add(r_y, s_y))
    const_idx = -t_y.offset
    t_coeffs = t_y.coeffs.clone()
    t_coeffs[const_idx] = limb.sub(t_coeffs[const_idx], k_y, FR)
    t_y = Laurent(t_y.offset, t_coeffs)
    t_const_m = t_coeffs[const_idx]
    commit_t = commit_poly(srs, srs.d, t_y, check_hole=False)
    # zkP_3
    a_m, wa = open_poly(srs, z_m, r1)
    b_m, wb = open_poly(srs, limb.mul(y_m, z_m, FR), r1)
    _, wt = open_poly(srs, z_m, t_y)
    szy_m = evaluate(s_y, z_m)
    # helper (with m = 0 the S_j, W_j, W'_j and Q_j blocks are empty)
    if m == 0:
        su_y = s_at_u_of_y(circuit, u_m)
        c_j = commit_poly(srs, srs.d, su_y, check_hole=False)
        _, qv = open_poly(srs, v_m, su_y)
        helper = [c_j, qv]
        fzs = s2 = cns_m.new_zeros((0, cns_m.shape[-1]))
    else:
        cms, ws, w2, qs, c_j, qv, fzs, s2 = hsc_prove_device(
            srs, circuit, ys_st, zs_st, u_m, v_m
        )
        helper = [cms, ws, w2, qs, c_j, qv]
    parts = [commit_r, commit_t, wa, wb, wt] + helper
    scal = torch.cat([torch.stack([a_m, b_m, szy_m, t_const_m]), fzs, s2], 0)
    return parts, scal


def _stack_points(points) -> Jacobian:
    """[single or (m,) batched Jacobians] -> one (4m+7,) Jacobian."""
    return cat([p.map(lambda a: a.reshape(-1, a.shape[-1])) for p in points])


def prove(srs: SRS, assignment: DeviceAssignment, circuit: DeviceCircuit,
          rnd: gp.Randomness) -> tuple[gp.Proof, gp.RndOracle]:
    """Protocol.hs:47-109 with explicit randomness; device compute on the
    assignment's device."""
    n = assignment.n
    if srs.d < 7 * n:
        raise ValueError(
            f"Parameter d is not large enough: {srs.d} should be > {7 * n}"
        )
    dev = assignment.aL.device
    m = len(rnd.ys)
    cns_m = FR.from_int(rnd.cns, device=dev)
    y_m = FR.from_int(rnd.y, device=dev)
    z_m = FR.from_int(rnd.z, device=dev)
    u_m = FR.from_int(rnd.u, device=dev)
    v_m = FR.from_int(rnd.v, device=dev)
    ys_st = FR.from_int(list(rnd.ys), device=dev).reshape(m, FR.nlimbs)
    zs_st = FR.from_int(list(rnd.zs), device=dev).reshape(m, FR.nlimbs)
    oracle = gp.RndOracle(rnd.y, rnd.z, list(zip(rnd.ys, rnd.zs)))

    allj, scal = _prove_compute(
        srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m
    )
    # ONE batched affine conversion + ONE fetch for all 4m+7 points and
    # 2m+4 scalars of the proof
    pts = jacobians_to_host(allj)
    evs = [int(v) for v in FR.to_int(scal)]
    a_i, b_i, s_i, tc_i = evs[:4]
    if tc_i != 0:
        raise IndexError(
            "commitPoly: nonzero coefficient at alpha*x^0 (g^alpha is "
            "not in the SRS)"
        )
    fzs_i, s2_i = evs[4 : 4 + m], evs[4 + m :]
    r_h, t_h, wa_h, wb_h, wt_h = pts[:5]
    cms_h, ws_h = pts[5 : 5 + m], pts[5 + m : 5 + 2 * m]
    w2_h, qs_h = pts[5 + 2 * m : 5 + 3 * m], pts[5 + 3 * m : 5 + 4 * m]
    c_h, qv_h = pts[5 + 4 * m], pts[5 + 4 * m + 1]
    hsc = gp.HscProof(
        hsc_s=[(cms_h[j], (fzs_i[j], ws_h[j])) for j in range(m)],
        hsc_w=[(s2_i[j], w2_h[j], qs_h[j]) for j in range(m)],
        hsc_qv=qv_h,
        hsc_c=c_h,
        hsc_u=rnd.u % gp.P,
        hsc_v=rnd.v % gp.P,
    )
    proof = gp.Proof(
        pr_r=r_h,
        pr_t=t_h,
        pr_a=a_i,
        pr_wa=wa_h,
        pr_b=b_i,
        pr_wb=wb_h,
        pr_wt=wt_h,
        pr_s=s_i,
        pr_hsc=hsc,
    )
    return proof, oracle


def verify(srs: SRS, circuit: DeviceCircuit, proof: gp.Proof, y: int, z: int,
           yzs: list) -> bool:
    """Protocol.hs:111-130: device recompute of k(y) and s values, host
    pairings. All 3m+4 pcV checks merge into ONE batched pairing product
    (commitment.pcv_batch; SONIC_TPU_NO_BATCH_PCV=1 makes it check them
    one by one, the reference's shape)."""
    n = circuit.n
    y_m = FR.from_int(y, device=circuit.wL.device)
    k_y = FR.to_int(k_at_y(circuit, n, y_m))
    t = (proof.pr_a * ((proof.pr_b + proof.pr_s) % gp.P) - k_y) % gp.P
    checks = hsc_checks(srs, circuit, yzs, proof.pr_hsc)
    checks.append((n, proof.pr_r, z, proof.pr_a, proof.pr_wa))
    checks.append((n, proof.pr_r, y * z % gp.P, proof.pr_b, proof.pr_wb))
    checks.append((srs.d, proof.pr_t, z, t, proof.pr_wt))
    return pcv_batch(srs, checks)
