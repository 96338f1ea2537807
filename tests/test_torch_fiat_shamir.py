"""PyTorch port, Fiat-Shamir: sonic_tpu_torch.fiat_shamir.prove_device vs
sonic_tpu.fiat_shamir.prove (the JAX package's host transcript prover) on
example2, proof bytes and derived challenges; the port's verify accepts the
proof and rejects one whose hsc u is not the transcript's. All comparisons
are exact.
"""
import json
import os

import torch

from sonic_tpu import fiat_shamir as jfs
from sonic_tpu import golden_protocol as jgp
from sonic_tpu import serial as jserial
from sonic_tpu.circuit import example_circuit_2 as jexample_circuit_2
from sonic_tpu_torch import fiat_shamir, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import example_circuit_2
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.srs import SRS

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "pinned_v1.json")

torch.set_num_threads(1)

BLINDING = [11, 22, 33, 44]


def test_prove_device_matches_sonic_tpu_and_verifies():
    with open(VEC_PATH) as f:
        vec = json.load(f)["example2"]
    host_srs = gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"])
    circuit, assignment = example_circuit_2(x=1, z=2)
    srs = SRS.from_host(host_srs, device="cpu")
    nizk = fiat_shamir.prove_device(
        srs,
        DeviceAssignment.from_host(assignment, device="cpu"),
        DeviceCircuit.from_host(circuit, device="cpu"),
        BLINDING,
    )
    jcircuit, jassignment = jexample_circuit_2(x=1, z=2)
    jhost_srs = jgp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"])
    want = jfs.prove(jhost_srs, jassignment, jcircuit, BLINDING)
    assert serial.proof_to_bytes(nizk.proof) == jserial.proof_to_bytes(want.proof)
    assert (nizk.y, nizk.z, nizk.yzs) == (want.y, want.z, want.yzs)
    assert fiat_shamir.verify(host_srs, circuit, nizk)

    hsc = nizk.proof.pr_hsc
    bad_hsc = gp.HscProof(hsc.hsc_s, hsc.hsc_w, hsc.hsc_qv, hsc.hsc_c,
                          (hsc.hsc_u + 1) % gp.P, hsc.hsc_v)
    p = nizk.proof
    bad = fiat_shamir.NizkProof(
        gp.Proof(p.pr_r, p.pr_t, p.pr_a, p.pr_wa, p.pr_b, p.pr_wb, p.pr_wt, p.pr_s, bad_hsc),
        nizk.y, nizk.z, nizk.yzs,
    )
    assert not fiat_shamir.verify(host_srs, circuit, bad)
