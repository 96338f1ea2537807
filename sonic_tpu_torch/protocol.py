"""The Sonic protocol: device prover and hybrid verifier, in PyTorch.

Port of `sonic_tpu/protocol.py` (`prove`, `prove_batch`, `verify`).
Reference: src/Sonic/Protocol.hs, with the reference's prover-supplied
challenges (explicit `Randomness`, no Fiat-Shamir):

  zkP_1  r'(X,1) build + commit            -> build + MSM
  zkP_2  t(X,y) = r(X,1)(r(X,y)+s(X,y))-k(y) -> dense Laurent product + MSM
  zkP_3  three openings                    -> synthetic division + MSM
  helper hscProve                          -> batched builds + MSMs

The verifier recomputes s/k on the device and checks the pairings on the
host. Proofs come back in host (golden_protocol) form, so the golden, JAX
and PyTorch provers compare bit for bit.
"""
from __future__ import annotations

import collections

import torch

from . import budget
from . import golden_protocol as gp
from .commitment import (
    commit_poly,
    commit_poly_batched,
    jacobians_to_host,
    open_poly,
    open_poly_batched,
    pcv_batch,
    stack_points,
)
from .constraints import (
    DeviceAssignment,
    DeviceCircuit,
    k_at_y,
    k_at_y_batch,
    r_at_y,
    r_at_y_batch,
    r_x1_batch,
    r_x1_poly,
    s_at_u_batch,
    s_at_u_of_y,
    s_at_y,
    s_at_y_batch,
    shared_rows,
    stack_assignments,
    stack_circuits,
)
from .fields import limb
from .fields.limb import FR
from .msm.pippenger import combine_windows
from .poly import laurent
from .poly.laurent import Laurent, evaluate
from .signature import hsc_assemble, hsc_checks, hsc_prove_device
from .srs import SRS
from .utils.trace import span

# (B, helper slices) -> calls of prove_batch; breakdown's phase tables read it
helper_slicings: collections.Counter = collections.Counter()


def _prove_compute(srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m,
                   mesh=None):
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
        srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m, mesh
    )
    return stack_points(combine_windows(parts)), scal


def _prove_phases(srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m,
                  mesh=None):
    n = assignment.n
    m = ys_st.shape[0]
    # zkP_1
    r1 = r_x1_poly(assignment, cns_m)
    commit_r = commit_poly(srs, n, r1, mesh=mesh)
    # zkP_2
    r_y = r_at_y(r1, y_m)
    s_y = s_at_y(circuit, y_m)
    k_y = k_at_y(circuit, n, y_m)
    t_y = laurent.mul(r1, laurent.add(r_y, s_y), mesh)
    del r_y
    const_idx = -t_y.offset
    t_coeffs = t_y.coeffs.clone()
    t_coeffs[const_idx] = limb.sub(t_coeffs[const_idx], k_y, FR)
    t_y = Laurent(t_y.offset, t_coeffs)
    t_const_m = t_coeffs[const_idx].clone()
    del t_coeffs
    commit_t = commit_poly(srs, srs.d, t_y, check_hole=False, mesh=mesh)
    # zkP_3; r', t and s(X, y) go before the helper
    a_m, wa = open_poly(srs, z_m, r1, mesh)
    b_m, wb = open_poly(srs, limb.mul(y_m, z_m, FR), r1, mesh)
    del r1
    _, wt = open_poly(srs, z_m, t_y, mesh)
    del t_y
    szy_m = evaluate(s_y, z_m)
    del s_y
    # helper (with m = 0 the S_j, W_j, W'_j and Q_j blocks are empty)
    if m == 0:
        su_y = s_at_u_of_y(circuit, u_m)
        c_j = commit_poly(srs, srs.d, su_y, check_hole=False, mesh=mesh)
        _, qv = open_poly(srs, v_m, su_y, mesh)
        helper = [c_j, qv]
        fzs = s2 = cns_m.new_zeros((0, cns_m.shape[-1]))
    else:
        cms, ws, w2, qs, c_j, qv, fzs, s2 = hsc_prove_device(
            srs, circuit, ys_st, zs_st, u_m, v_m, mesh
        )
        helper = [cms, ws, w2, qs, c_j, qv]
    parts = [commit_r, commit_t, wa, wb, wt] + helper
    scal = torch.cat([torch.stack([a_m, b_m, szy_m, t_const_m]), fzs, s2], 0)
    return parts, scal


@span("sonic.prove")
def prove(srs: SRS, assignment: DeviceAssignment, circuit: DeviceCircuit,
          rnd: gp.Randomness, mesh=None) -> tuple[gp.Proof, gp.RndOracle]:
    """Protocol.hs:47-109 with explicit randomness; device compute on the
    assignment's device.

    With `mesh` (a 1-D DeviceMesh, parallel/mesh.py), every rank calls
    prove with the same inputs: each commit and opening shards its MSM's
    points over the ranks, the t(X, y) product takes the sharded four-step
    NTT where it is large enough, and every rank returns the same proof,
    equal to the single-rank one."""
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
        srs, assignment, circuit, cns_m, y_m, z_m, ys_st, zs_st, u_m, v_m, mesh
    )
    # ONE batched affine conversion + ONE fetch for all 4m+7 points and
    # 2m+4 scalars of the proof
    with span("sonic.protocol.fetch"):
        pts = jacobians_to_host(allj)
        evs = [int(v) for v in FR.to_int(scal)]
    a_i, b_i, s_i, tc_i = evs[:4]
    _check_t_hole([tc_i])
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


def _check_t_hole(t_consts) -> None:
    """The reference's panic for a violating assignment: t's X^0 coefficient
    would meet the missing g^alpha row (CommitmentScheme.hs:70-73)."""
    if any(t_consts):
        raise IndexError(
            "commitPoly: nonzero coefficient at alpha*x^0 (g^alpha is "
            "not in the SRS)"
        )


def _proof_slices(B: int, unit_bytes: int) -> list:
    """[lo, hi) ranges of the proof axis, as even as the step budget
    allows at `unit_bytes` a proof, at least one proof a slice."""
    k = -(-B // budget.per_step(unit_bytes))
    return [(B * i // k, B * (i + 1) // k) for i in range(k)]


def _helper_slices(B: int, m: int, n: int) -> list:
    """The helper's slices of the proofs: a proof carries m helper
    instances of 3n + 1 coefficients at `budget.HELPER_BYTES` a
    coefficient. One slice at n <= 1024."""
    return _proof_slices(B, budget.HELPER_BYTES * m * (3 * n + 1))


def _cat(parts: list) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@span("sonic.prove_batch")
def prove_batch(srs: SRS, assignments: list, circuits: list, rnds: list, mesh=None) -> list:
    """B independent, shape-identical circuits in one device pipeline
    (BASELINE config 5). zkP_1-3 batch over the proof axis: one r'(X,1)
    build, batched t(X,y) products, batched commitments and openings. The
    builds over the circuits run over slices of the proofs, each
    slice's circuits stacked in turn (one slice at n <= 1024): zkP_2's
    s(X, y_b), k(y_b) and t(X, y_b), and the helper (`_helper_slices`),
    which streams: each slice builds its proofs' m s(X, y_j) and
    s(u, Y), commits and opens them as batched pipelines, keeps only its
    MSMs' window totals and its evaluations, and frees the rest before
    the next slice. All B(4m+7) MSMs finish in ONE `combine_windows`,
    then one batched to_affine and one fetch, as in `prove`;
    `helper_slicings` counts the calls by (B, slices).

    Equal to B single `prove` calls, byte for byte (hsc u and v reduced
    mod P as `prove` does). Returns [(Proof, RndOracle)] in input order.
    With `mesh`, every commit and opening shards its MSM's points over the
    ranks, as in `prove`; the batched t product stays on each rank, as in
    the reference. Circuits given as sparse rows must share one pattern
    (`constraints.shared_rows`)."""
    B = len(assignments)
    n = assignments[0].n
    m = len(rnds[0].ys)
    if srs.d < 7 * n:
        raise ValueError(
            f"Parameter d is not large enough: {srs.d} should be > {7 * n}"
        )
    shared_rows(circuits)  # a mix of sparse patterns is refused before any work
    dev = assignments[0].aL.device
    cut = _helper_slices(B, m, n)
    helper_slicings[(B, len(cut))] += 1

    def fr(vals, *shape):
        return FR.from_int(vals, device=dev).reshape(shape + (FR.nlimbs,))

    cns = fr([r.cns for r in rnds], B, 4)
    ys, zs = fr([r.y for r in rnds], B), fr([r.z for r in rnds], B)
    us, vs = fr([r.u for r in rnds], B), fr([r.v for r in rnds], B)
    ys_h = fr([yi for r in rnds for yi in r.ys], B, m)
    zs_h = fr([zi for r in rnds for zi in r.zs], B * m)

    # zkP_1: blinded r'(X, 1) and its commitments
    off_r = -(2 * n + 4)
    r1 = r_x1_batch(stack_assignments(assignments), cns)  # (B, 3n+5, L)
    commit_r = commit_poly_batched(srs, n, off_r, r1, mesh=mesh)
    # zkP_2: t(X, y_b) = r'(X,1)(r'(X,y_b) + s(X,y_b)) - k(y_b), and
    # s(z_b, y_b), built a slice of the proofs at a time (the sum r + s of
    # 4n + 5 coefficients at `budget.COEFF_BYTES` a coefficient: a limb.add
    # holds ~10 operand-sized temporaries); the commitment batches over
    # all B
    t_c, szy = [], []
    for lo, hi in _proof_slices(B, budget.COEFF_BYTES * (4 * n + 5)):
        cir = stack_circuits(circuits[lo:hi])
        with span("sonic.poly.build"):
            s_y = s_at_y_batch(cir, ys[lo:hi])  # (k, 3n+1, L) at -n
        k_y = k_at_y_batch(cir, n, ys[lo:hi])
        del cir
        szy.append(laurent.evaluate_batched(-n, s_y, zs[lo:hi]))
        r1_k = r1[lo:hi]
        off_sum, rs = laurent.add_batched(off_r, r_at_y_batch(r1_k, ys[lo:hi], off_r), -n, s_y)
        del s_y
        t_k = laurent.mul_batched(r1_k, rs)
        del rs
        ci = -(off_r + off_sum)
        t_k[:, ci] = limb.sub(t_k[:, ci], k_y, FR)
        t_c.append(t_k)
    t_c, szy = _cat(t_c), _cat(szy)
    off_t = off_r + off_sum
    commit_t = commit_poly_batched(srs, srs.d, off_t, t_c, check_hole=False, mesh=mesh)
    # zkP_3: openings of r' at z_b and y_b z_b, then (r' gone) of t at z_b
    a_m, wa = open_poly_batched(srs, zs, off_r, r1, mesh)
    b_m, wb = open_poly_batched(srs, limb.mul(ys, zs, FR), off_r, r1, mesh)
    del r1
    _, wt = open_poly_batched(srs, zs, off_t, t_c, mesh)
    t_const = t_c[:, ci].clone()
    del t_c

    # helper, a slice of the proofs at a time (check_hole=False: s(X, y)'s
    # X^0 and s(u, Y)'s Y^0 coefficients are zero by construction); each
    # kind of MSM keeps its slices' window totals in proof order
    kinds = [[] for _ in range(6)]  # cms, ws, w2, qs, c, qv
    fzs, s2 = [], []
    with span("sonic.protocol.helper"):
        for lo, hi in cut:
            cir = stack_circuits(circuits[lo:hi])
            with span("sonic.poly.s_yj"):
                s = s_at_y_batch(cir, ys_h[lo:hi]).flatten(0, 1)  # (k m, 3n+1, L)
            su = s_at_u_batch(cir, us[lo:hi])  # (k, 2n+q+1, L) at -n
            del cir
            u_rep = us[lo:hi].repeat_interleave(m, 0)
            cms = commit_poly_batched(srs, srs.d, -n, s, check_hole=False, mesh=mesh)
            fz, ws = open_poly_batched(srs, zs_h[lo * m : hi * m], -n, s, mesh)
            _, w2 = open_poly_batched(srs, u_rep, -n, s, mesh)
            del s
            c = commit_poly_batched(srs, srs.d, -n, su, check_hole=False, mesh=mesh)
            s2_k, qs = open_poly_batched(srs, ys_h[lo:hi].flatten(0, 1), -n, su.repeat_interleave(m, 0),
                                         mesh)
            _, qv = open_poly_batched(srs, vs[lo:hi], -n, su, mesh)
            del su
            for kind, part in zip(kinds, (cms, ws, w2, qs, c, qv)):
                kind.append(part)
            fzs.append(fz)
            s2.append(s2_k)

    # ONE window combine, ONE batched to_affine + fetch for all B(4m+7)
    # points, and one fetch for the 4B + 2Bm scalars
    allj = stack_points(combine_windows(
        [commit_r, commit_t, wa, wb, wt] + [part for kind in kinds for part in kind]))
    with span("sonic.protocol.fetch"):
        pts = jacobians_to_host(allj)
        evs = [int(v) for v in FR.to_int(torch.cat([a_m, b_m, szy, t_const] + fzs + s2, 0))]
    a_i, b_i, s_i, tc_i = (evs[k * B : (k + 1) * B] for k in range(4))
    _check_t_hole(tc_i)
    fzs_i, s2_i = evs[4 * B : 4 * B + B * m], evs[4 * B + B * m :]
    r_h, t_h, wa_h, wb_h, wt_h = (pts[k * B : (k + 1) * B] for k in range(5))
    start = 5 * B
    cms_h, ws_h, w2_h, qs_h = (pts[start + k * B * m : start + (k + 1) * B * m] for k in range(4))
    c_h, qv_h = pts[start + 4 * B * m : start + 4 * B * m + B], pts[start + 4 * B * m + B :]
    hscs = hsc_assemble(
        B, m, c_h, qv_h, cms_h, fzs_i, ws_h, s2_i, w2_h, qs_h,
        [r.u % gp.P for r in rnds], [r.v % gp.P for r in rnds],
    )
    out = []
    for b, r in enumerate(rnds):
        proof = gp.Proof(
            pr_r=r_h[b], pr_t=t_h[b], pr_a=a_i[b], pr_wa=wa_h[b], pr_b=b_i[b],
            pr_wb=wb_h[b], pr_wt=wt_h[b], pr_s=s_i[b], pr_hsc=hscs[b],
        )
        out.append((proof, gp.RndOracle(r.y, r.z, list(zip(r.ys, r.zs)))))
    return out


def verify(srs: SRS, circuit: DeviceCircuit, proof: gp.Proof, y: int, z: int,
           yzs: list) -> bool:
    """Protocol.hs:111-130: device recompute of k(y) and s values, host
    pairings. All 3m+4 pcV checks merge into ONE batched pairing product
    (commitment.pcv_batch; SONIC_TPU_NO_BATCH_PCV=1 makes it check them
    one by one, the reference's shape)."""
    n = circuit.n
    y_m = FR.from_int(y, device=circuit.device)
    k_y = FR.to_int(k_at_y(circuit, n, y_m))
    t = (proof.pr_a * ((proof.pr_b + proof.pr_s) % gp.P) - k_y) % gp.P
    checks = hsc_checks(srs, circuit, yzs, proof.pr_hsc)
    checks.append((n, proof.pr_r, z, proof.pr_a, proof.pr_wa))
    checks.append((n, proof.pr_r, y * z % gp.P, proof.pr_b, proof.pr_wb))
    checks.append((srs.d, proof.pr_t, z, t, proof.pr_wt))
    return pcv_batch(srs, checks)
