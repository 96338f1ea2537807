"""PyTorch port, the slice as a whole: SRS -> prove -> verify.

(a) example1/example2 reproduce the proof bytes of
    tests/vectors/pinned_v1.json; (c) verify says True, and False on a
    tampered proof; (b) on random_circuit(Random(7), n=24, q=4), whose
    t(X,y) product (77 x 101 pairwise products) takes the NTT branch, the
    port's proof bytes equal the golden prover's with the same SRS, and the
    NTT product itself equals sonic_tpu.poly.laurent.mul on the same
    operands. (d), the SRS itself, is in test_torch_srs.py, and the proof
    against sonic_tpu.protocol.prove in test_torch_protocol_jax.py.

sonic_tpu.protocol.prove itself is held on example2 only: at n=24 its
XLA:CPU compiles alone take minutes. The golden prover at n=24 runs with
its G1 scalar multiplication taken by the native C++ library (a one-point
MSM), which keeps its Python protocol logic and cuts its run from ~45 s to
about a second. verify draws fresh 128-bit randomness (pcv_batch), so its
results are compared as booleans only.
"""
import json
import os
import random

import numpy as np
import pytest
import torch

from sonic_tpu import golden as jgolden
from sonic_tpu import golden_protocol as jgp
from sonic_tpu import serial as jserial
from sonic_tpu.poly import laurent as jlaurent
from sonic_tpu_torch import golden, native, protocol, serial, signature
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import example_circuit_1, example_circuit_2, random_circuit
from sonic_tpu_torch.constraints import (
    DeviceAssignment, DeviceCircuit, r_at_y, r_x1_poly, s_at_y,
)
from sonic_tpu_torch.fields.limb import FR
from sonic_tpu_torch.poly import laurent
from sonic_tpu_torch.srs import SRS

torch.set_num_threads(1)

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "pinned_v1.json")
with open(VEC_PATH) as f:
    VECTORS = json.load(f)
MAKERS = {"example1": example_circuit_1, "example2": example_circuit_2}


def _host_srs(name):
    """The vector's host SRS, G2 tables included."""
    vec = VECTORS[name]
    return gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"])


def _randomness(vec):
    r = vec["rnd"]
    return gp.Randomness(
        cns=r["cns"], y=r["y"], z=r["z"], ys=r["ys"], zs=r["zs"], u=r["u"], v=r["v"]
    )


def _verify_and_tamper(srs, dc, proof, oracle):
    assert protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs) is True
    assert signature.hsc_verify(srs, dc, oracle.yzs, proof.pr_hsc) is True
    proof.pr_a = (proof.pr_a + 1) % gp.P
    assert protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs) is False


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_pinned_vectors(name):
    vec = VECTORS[name]
    circuit, assignment = MAKERS[name](x=1, z=2)
    srs = SRS.from_host(_host_srs(name), device="cpu")
    dc = DeviceCircuit.from_host(circuit, device="cpu")
    da = DeviceAssignment.from_host(assignment, device="cpu")
    proof, oracle = protocol.prove(srs, da, dc, _randomness(vec))
    assert serial.proof_to_bytes(proof).hex() == vec["proof_hex"]
    _verify_and_tamper(srs, dc, proof, oracle)


def _native_g1_mul(p, k):
    return native.g1_msm_native([p], [k % gp.P])


def test_random_circuit_in_the_ntt_branch(monkeypatch):
    rng = random.Random(7)
    n, q = 24, 4
    circuit, assignment = random_circuit(rng, n=n, q=q)
    d = 7 * n
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    rnd = gp.Randomness.generate(rng, q)
    assert native.get_lib() is not None
    monkeypatch.setattr(jgolden, "g1_mul", _native_g1_mul)
    # the golden SRS's G1 tables (gp.SRS.new's, without the unread G2 ones)
    P, xinv, g = gp.P, pow(x, -1, gp.P), golden.G1_GEN
    neg = [pow(xinv, i, P) for i in range(1, d + 1)]
    pos = [pow(x, i, P) for i in range(d + 1)]
    host = jgp.SRS(
        d=d,
        g_neg_x=[_native_g1_mul(g, e) for e in neg],
        g_pos_x=[_native_g1_mul(g, e) for e in pos],
        h_neg_x=[], h_pos_x=[],
        g_neg_ax=[_native_g1_mul(g, alpha * e) for e in neg],
        g_pos_ax=[_native_g1_mul(g, alpha * e) for e in pos[1:]],
        h_neg_ax=[], h_pos_ax=[],
    )
    want, _ = jgp.prove(host, assignment, circuit, jgp.Randomness(**vars(rnd)))

    srs = SRS.from_host(host, device="cpu")
    for key, e in ((("x", n - d), pow(x, n - d, P)), (("x", 0), 1), (("ax", 0), alpha),
                   (("ax", 1), alpha * x % P)):
        srs.h_rows[key] = golden.g2_mul(golden.G2_GEN, e)
    dc = DeviceCircuit.from_host(circuit, device="cpu")
    da = DeviceAssignment.from_host(assignment, device="cpu")
    got, oracle = protocol.prove(srs, da, dc, rnd)
    assert serial.proof_to_bytes(got) == jserial.proof_to_bytes(want)
    _verify_and_tamper(srs, dc, got, oracle)

    # the t(X, y) product on the NTT branch equals sonic_tpu's
    y = FR.from_int(rnd.y)
    r1 = r_x1_poly(da, FR.from_int(rnd.cns))
    rs = laurent.add(r_at_y(r1, y), s_at_y(dc, y))
    assert r1.length * rs.length >= laurent._NTT_THRESHOLD
    t = laurent.mul(r1, rs)
    jt = jlaurent.mul(
        jlaurent.Laurent(r1.offset, r1.coeffs.numpy().astype(np.uint32)),
        jlaurent.Laurent(rs.offset, rs.coeffs.numpy().astype(np.uint32)),
    )
    assert jt.offset == t.offset
    assert np.array_equal(np.asarray(jt.coeffs).astype(np.int64), t.coeffs.numpy())


def test_breakdown_phase_timers_leave_the_proof_unchanged():
    """sonic_tpu_torch.breakdown's timers on the example2 prove: the proof
    bytes stay the pinned ones, every prover phase is timed, and the
    prover's functions are restored afterwards."""
    from sonic_tpu_torch import breakdown, commitment
    from sonic_tpu_torch.msm import bucket_acc, pippenger

    vec = VECTORS["example2"]
    circuit, assignment = example_circuit_2(x=1, z=2)
    srs = SRS.from_host(_host_srs("example2"), device="cpu")
    dc = DeviceCircuit.from_host(circuit, device="cpu")
    da = DeviceAssignment.from_host(assignment, device="cpu")
    cpu = torch.device("cpu")
    with breakdown.phase_timers(cpu) as acc:
        proof, _ = protocol.prove(srs, da, dc, _randomness(vec))
    assert serial.proof_to_bytes(proof).hex() == vec["proof_hex"]
    assert acc["commit r, t (zkP_1/2)"][1] == 2 and acc["3 openings (zkP_3)"][1] == 3
    assert acc["window combine, all MSMs"][1] == 1
    assert acc["in MSMs: bucket sums (kernel 2)"][1] == 11  # m = 5: 5 + 6 MSM calls
    assert acc["in MSMs: bucket plan"][1] == 11
    assert set(acc) == {label for _, _, label in breakdown.PHASES}
    assert protocol.commit_poly is commitment.commit_poly
    assert pippenger.bucket_sums is bucket_acc.bucket_sums
    # the profiler pass, on a small host read (the CPU has no device events)
    one = FR.from_int([3, 4])
    wall, events, busy, rows = breakdown.device_profile(lambda: FR.to_int(one), cpu)
    assert wall > 0 and events == 0 and busy == 0 and rows == []


def test_hsc_prove_matches_golden_and_verifies():
    """signature.hsc_prove (the helper alone, as sonic_tpu exports it) equals
    the golden hscProve at n=2, q=2 with the same (y_j, z_j), u and v;
    hsc_verify accepts it and rejects a wrong u (tests/test_signature.py's
    shapes)."""
    rng = random.Random(502)
    circuit, _ = random_circuit(rng, n=2, q=2)
    host_srs = gp.SRS.new(7 * 2 + 5, x=rng.randrange(2, gp.P), alpha=rng.randrange(2, gp.P))
    srs = SRS.from_host(host_srs, device="cpu")
    dc = DeviceCircuit.from_host(circuit, device="cpu")
    yzs = [(rng.randrange(2, gp.P), rng.randrange(2, gp.P)) for _ in range(2)]
    u, v = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    yzs_m = [(FR.from_int(y), FR.from_int(z)) for y, z in yzs]
    got = signature.hsc_prove(srs, dc, yzs_m, FR.from_int(u), FR.from_int(v))
    assert got == gp.hsc_prove(host_srs, gp.s_poly(circuit.weights), yzs, u, v)
    assert signature.hsc_verify(srs, dc, yzs, got)
    bad = gp.HscProof(got.hsc_s, got.hsc_w, got.hsc_qv, got.hsc_c, (u + 1) % gp.P, v)
    assert not signature.hsc_verify(srs, dc, yzs, bad)
