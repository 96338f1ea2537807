"""Fiat-Shamir transform, in PyTorch: non-interactive Sonic proofs.

The transcript, `NizkProof`, and the host `prove` / `verify` are a JAX-free
copy of `sonic_tpu/fiat_shamir.py` (unchanged); `prove_device` and
`_device_circuit_to_host` are rewritten over the port's device prover.
The original's docstring follows.

Fiat-Shamir transform — non-interactive Sonic proofs (EXTENSION).

The reference implements only the INTERACTIVE protocol with prover-sampled
challenges handed to the verifier via RndOracle (Protocol.hs:66,76,84-86;
SURVEY.md §3.4 notes there is no Fiat-Shamir anywhere in it). This module
is the clearly-separated non-interactive extension: every challenge is
derived from a SHA-512 transcript over canonical encodings (serial.py), so
proofs are self-contained and publicly verifiable.

Transcript schedule (each challenge depends on everything the prover has
committed to before it, matching the interactive message order):

  absorb(circuit, d) ; absorb(R)            -> y
  absorb(T)                                 -> z
  absorb(a, Wa, b, Wb, Wt, s)               -> y_1..y_m, z_1..z_m
  absorb(S_j commits + (s_j, W_j) opens)    -> u
  absorb(C)                                 -> v

prove/verify here run on the golden (host) backend; the device prover
produces bit-identical proofs for identical randomness, so the transform
applies unchanged (tests cross-check).
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch

from . import golden_protocol as gp
from . import serial
from .circuit import ArithCircuit, Assignment
from .fields.constants import R_MOD


class Transcript:
    """SHA-512 based Fiat-Shamir transcript with domain separation."""

    def __init__(self, domain: bytes = b"sonic-tpu-v1"):
        self._state = hashlib.sha512(domain).digest()

    def absorb(self, label: bytes, data: bytes) -> None:
        h = hashlib.sha512()
        h.update(self._state)
        h.update(len(label).to_bytes(2, "little"))
        h.update(label)
        h.update(len(data).to_bytes(8, "little"))
        h.update(data)
        self._state = h.digest()

    def absorb_fr(self, label: bytes, v: int) -> None:
        self.absorb(label, serial.fr_to_bytes(v))

    def absorb_g1(self, label: bytes, p) -> None:
        self.absorb(label, serial.g1_to_bytes(p))

    def challenge_fr(self, label: bytes) -> int:
        """Squeeze one Fr challenge in [1, r): 64 hash bytes mod r keeps
        modulo bias below 2^-250."""
        h = hashlib.sha512()
        h.update(self._state)
        h.update(b"challenge")
        h.update(label)
        out = h.digest()
        self._state = hashlib.sha512(self._state + out).digest()
        return int.from_bytes(out, "little") % (R_MOD - 1) + 1


def _absorb_circuit(tr: Transcript, circuit: ArithCircuit, d: int) -> None:
    w = circuit.weights
    tr.absorb(b"d", int(d).to_bytes(8, "little"))
    tr.absorb(b"n", int(w.n).to_bytes(8, "little"))
    tr.absorb(b"q", int(w.q).to_bytes(8, "little"))
    for name, mat in ((b"wL", w.wL), (b"wR", w.wR), (b"wO", w.wO)):
        for row in mat:
            tr.absorb(name, b"".join(serial.fr_to_bytes(v) for v in row))
    tr.absorb(b"cs", b"".join(serial.fr_to_bytes(v) for v in circuit.cs))


@dataclasses.dataclass
class NizkProof:
    """Interactive proof + the derived challenges (for debugging; verify
    recomputes them and rejects a proof whose embedded hsc u/v differ)."""

    proof: gp.Proof
    y: int
    z: int
    yzs: list


def prove(
    srs: gp.SRS,
    assignment: Assignment,
    circuit: ArithCircuit,
    blinding: list[int],
) -> NizkProof:
    """Non-interactive prove. `blinding`: the 4 secret blinding scalars
    c_{n+1..n+4} (the ONLY randomness left — everything else is derived)."""
    n = assignment.n
    m = circuit.weights.q
    if srs.d < 7 * n:
        raise ValueError(
            f"Parameter d is not large enough: {srs.d} should be > {7 * n}"
        )
    tr = Transcript()
    _absorb_circuit(tr, circuit, srs.d)

    # zkP_1
    sumc = {
        -(2 * n + i): {-(2 * n + i): blinding[i - 1] % gp.P}
        for i in range(1, 5)
    }
    poly_r1 = gp.bp_add(gp.r_poly(assignment), sumc)
    r_x1 = gp.bp_eval_y(1, poly_r1)
    commit_r = gp.commit_poly(srs, n, r_x1)
    tr.absorb_g1(b"R", commit_r)
    y = tr.challenge_fr(b"y")

    # zkP_2
    k_y = gp.k_poly(circuit.cs, n)
    s_xy = gp.s_poly(circuit.weights)
    t_xy = gp.t_poly(poly_r1, s_xy, k_y)
    t_xy_at_y = gp.bp_eval_y(y, t_xy)
    commit_t = gp.commit_poly(srs, srs.d, t_xy_at_y)
    tr.absorb_g1(b"T", commit_t)
    z = tr.challenge_fr(b"z")

    # zkP_3
    a, wa = gp.open_poly(srs, z, r_x1)
    b, wb = gp.open_poly(srs, y * z % gp.P, r_x1)
    _, wt = gp.open_poly(srs, z, t_xy_at_y)
    szy = gp.lp_eval(gp.bp_eval_y(y, s_xy), z)
    tr.absorb_fr(b"a", a)
    tr.absorb_g1(b"Wa", wa)
    tr.absorb_fr(b"b", b)
    tr.absorb_g1(b"Wb", wb)
    tr.absorb_g1(b"Wt", wt)
    tr.absorb_fr(b"s", szy)
    ys = [tr.challenge_fr(b"y_%d" % j) for j in range(m)]
    zs = [tr.challenge_fr(b"z_%d" % j) for j in range(m)]
    yzs = list(zip(ys, zs))

    # helper protocol, transcript-interleaved (Signature.hs:32-72 order)
    ss = []
    for yi, zi in yzs:
        s_at_yi = gp.bp_eval_y(yi, s_xy)
        cm = gp.commit_poly(srs, srs.d, s_at_yi)
        op = gp.open_poly(srs, zi, s_at_yi)
        ss.append((cm, op))
        tr.absorb_g1(b"S_j", cm)
        tr.absorb_fr(b"s_j", op[0])
        tr.absorb_g1(b"W_j", op[1])
    u = tr.challenge_fr(b"u")

    su_y = gp.bp_eval_x(u, s_xy)
    c = gp.commit_poly(srs, srs.d, su_y)
    tr.absorb_g1(b"C", c)
    v = tr.challenge_fr(b"v")

    sw = []
    for yi, _zi in yzs:
        _, wj2 = gp.open_poly(srs, u, gp.bp_eval_y(yi, s_xy))
        sj2, qj = gp.open_poly(srs, yi, su_y)
        sw.append((sj2, wj2, qj))
    _, qv = gp.open_poly(srs, v, su_y)
    hsc = gp.HscProof(ss, sw, qv, c, u, v)

    proof = gp.Proof(commit_r, commit_t, a, wa, b, wb, wt, szy, hsc)
    return NizkProof(proof, y, z, yzs)


def verify(srs: gp.SRS, circuit: ArithCircuit, nizk: NizkProof) -> bool:
    """Recompute every challenge from the transcript; reject on mismatch
    with the proof's embedded values; then run the interactive verifier."""
    proof = nizk.proof
    m = circuit.weights.q
    tr = Transcript()
    _absorb_circuit(tr, circuit, srs.d)
    tr.absorb_g1(b"R", proof.pr_r)
    y = tr.challenge_fr(b"y")
    tr.absorb_g1(b"T", proof.pr_t)
    z = tr.challenge_fr(b"z")
    tr.absorb_fr(b"a", proof.pr_a)
    tr.absorb_g1(b"Wa", proof.pr_wa)
    tr.absorb_fr(b"b", proof.pr_b)
    tr.absorb_g1(b"Wb", proof.pr_wb)
    tr.absorb_g1(b"Wt", proof.pr_wt)
    tr.absorb_fr(b"s", proof.pr_s)
    ys = [tr.challenge_fr(b"y_%d" % j) for j in range(m)]
    zs = [tr.challenge_fr(b"z_%d" % j) for j in range(m)]
    yzs = list(zip(ys, zs))
    if len(proof.pr_hsc.hsc_s) != m:
        return False
    for (cm, (s_j, w_j)) in proof.pr_hsc.hsc_s:
        tr.absorb_g1(b"S_j", cm)
        tr.absorb_fr(b"s_j", s_j)
        tr.absorb_g1(b"W_j", w_j)
    u = tr.challenge_fr(b"u")
    tr.absorb_g1(b"C", proof.pr_hsc.hsc_c)
    v = tr.challenge_fr(b"v")
    if proof.pr_hsc.hsc_u != u or proof.pr_hsc.hsc_v != v:
        return False
    if (y, z, yzs) != (nizk.y, nizk.z, nizk.yzs):
        return False
    return gp.verify(srs, circuit, proof, y, z, yzs)


def prove_device(srs, assignment, circuit, blinding: list[int]) -> NizkProof:
    """Non-interactive prove on the device prover.

    Same transcript schedule as `prove`: challenge derivation only fixes the
    ORDER values are absorbed, not where they are computed, so the m helper
    commits and openings still run as batched MSM pipelines (all y_j are
    squeezed together before the S_j block). Each transcript stage finishes
    its MSMs in one window combine and fetches its points in one batched
    to_affine. Byte-identical to the golden `prove` for identical blinding.

    srs: the port's device SRS; assignment/circuit: DeviceAssignment /
    DeviceCircuit, on the device the proof is computed on."""
    from .commitment import commit_poly, msms_to_host, open_poly
    from .constraints import k_at_y, r_at_y, r_x1_poly, s_at_u_of_y, s_at_y
    from .fields import limb
    from .fields.limb import FR
    from .poly import laurent
    from .poly.laurent import Laurent, evaluate
    from .signature import hsc_cu_device, hsc_sj_device

    n = assignment.n
    m = circuit.q
    if srs.d < 7 * n:
        raise ValueError(
            f"Parameter d is not large enough: {srs.d} should be > {7 * n}"
        )
    dev = assignment.aL.device

    def fr(v):
        return FR.from_int(v, device=dev)

    def ints(t):
        return [int(v) for v in FR.to_int(t.reshape(-1, FR.nlimbs))]

    tr = Transcript()
    _absorb_circuit(tr, _device_circuit_to_host(circuit), srs.d)

    # zkP_1
    r1 = r_x1_poly(assignment, fr(blinding))
    (commit_r,) = msms_to_host([commit_poly(srs, n, r1)])
    tr.absorb_g1(b"R", commit_r)
    y = tr.challenge_fr(b"y")

    # zkP_2
    y_m = fr(y)
    s_y = s_at_y(circuit, y_m)
    t_y = laurent.mul(r1, laurent.add(r_at_y(r1, y_m), s_y))
    ci = -t_y.offset
    t_coeffs = t_y.coeffs.clone()
    t_coeffs[ci] = limb.sub(t_coeffs[ci], k_at_y(circuit, n, y_m), FR)
    t_y = Laurent(t_y.offset, t_coeffs)
    (commit_t,) = msms_to_host([commit_poly(srs, srs.d, t_y)])
    tr.absorb_g1(b"T", commit_t)
    z = tr.challenge_fr(b"z")

    # zkP_3
    z_m = fr(z)
    a_m, wa = open_poly(srs, z_m, r1)
    b_m, wb = open_poly(srs, limb.mul(y_m, z_m, FR), r1)
    _, wt = open_poly(srs, z_m, t_y)
    wa_h, wb_h, wt_h = msms_to_host([wa, wb, wt])
    a, b, szy = ints(torch.stack([a_m, b_m, evaluate(s_y, z_m)]))
    tr.absorb_fr(b"a", a)
    tr.absorb_g1(b"Wa", wa_h)
    tr.absorb_fr(b"b", b)
    tr.absorb_g1(b"Wb", wb_h)
    tr.absorb_g1(b"Wt", wt_h)
    tr.absorb_fr(b"s", szy)
    ys = [tr.challenge_fr(b"y_%d" % j) for j in range(m)]
    zs = [tr.challenge_fr(b"z_%d" % j) for j in range(m)]
    yzs = list(zip(ys, zs))

    # helper: the interactive prover's batched device blocks, with the
    # transcript absorbing between them where u and v are squeezed
    ys_m = fr(ys).reshape(m, FR.nlimbs)
    s_coeffs, cms_j, fzs, ws = hsc_sj_device(srs, circuit, ys_m, fr(zs).reshape(m, FR.nlimbs))
    pts = msms_to_host([cms_j, ws])
    fzs_i = ints(fzs)
    ss = []
    for j in range(m):
        ss.append((pts[j], (fzs_i[j], pts[m + j])))
        tr.absorb_g1(b"S_j", pts[j])
        tr.absorb_fr(b"s_j", fzs_i[j])
        tr.absorb_g1(b"W_j", pts[m + j])
    u = tr.challenge_fr(b"u")

    # v is derived from C, so C is committed and fetched before the
    # openings that use v; su_y and c go back into hsc_cu_device
    u_m = fr(u)
    su_y = s_at_u_of_y(circuit, u_m)
    c_j = commit_poly(srs, srs.d, su_y, check_hole=False)
    (c,) = msms_to_host([c_j])
    tr.absorb_g1(b"C", c)
    v = tr.challenge_fr(b"v")

    _, w2, s2, qs, qv = hsc_cu_device(srs, circuit, s_coeffs, u_m, ys_m, fr(v), su_y=su_y, c=c_j)
    pts = msms_to_host([w2, qs, qv])
    s2_i = ints(s2)
    sw = [(s2_i[j], pts[j], pts[m + j]) for j in range(m)]
    hsc = gp.HscProof(ss, sw, pts[2 * m], c, u, v)

    proof = gp.Proof(commit_r, commit_t, a, wa_h, b, wb_h, wt_h, szy, hsc)
    return NizkProof(proof, y, z, yzs)


def _device_circuit_to_host(circuit) -> ArithCircuit:
    """DeviceCircuit -> host ArithCircuit (for transcript absorption). The
    transcript absorbs the dense weight matrices, which a circuit given as
    sparse rows (`DeviceCircuit.from_rows`) does not have."""
    if circuit.rows is not None:
        raise ValueError(
            "fiat_shamir.prove_device absorbs the dense weight matrices into its transcript; "
            "a circuit given as sparse rows (DeviceCircuit.from_rows) has none"
        )
    from .circuit import GateWeights
    from .fields.limb import FR

    def rows(mat):
        return [[int(v) for v in row] for row in FR.to_int(mat)]

    w = GateWeights(wL=rows(circuit.wL), wR=rows(circuit.wR), wO=rows(circuit.wO))
    return ArithCircuit(w, [int(v) for v in FR.to_int(circuit.cs)])
