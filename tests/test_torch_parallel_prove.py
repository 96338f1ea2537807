"""PyTorch port, sharded proving: protocol.prove(mesh=...) in gloo worlds
of 2 and 4 ranks, every rank's proof equal, as `serial` bytes, to the JAX
package's single-device oracle for the same inputs, and verify True; in
the world of 2, the first circuit given as sparse rows too
(`DeviceCircuit.from_rows`).

Two circuits, built as tests/test_prove_sharded.py and the JAX package's
multichip dry run build theirs: n=4, q=3 (the t(X, y) product below the
NTT threshold: schoolbook), and n=8, q=2 under SONIC_TPU_NTT_THRESHOLD=512,
where the t product crosses the threshold and runs the four-step sharded
NTT inside prove (N = 64 = 8 x 8). The reference is
`sonic_tpu.golden_protocol.prove`, which the JAX package's own tests hold
equal to `sonic_tpu.protocol.prove` on these inputs; the JAX device
prover's XLA:CPU compiles at these shapes take 70-100 s, so it is not
called here.

No jax or sonic_tpu import at the top level: the ranks import this module.
"""
import os
import random

import pytest
import torch

from test_torch_parallel import init_rank, run_world, save_rank

torch.set_num_threads(1)

# (n, q, seed, SONIC_TPU_NTT_THRESHOLD)
CASES = [(4, 3, 31, None), (8, 2, 17, "512")]


def _setup(rng, n, q, random_circuit, gp):
    circuit, assignment = random_circuit(rng, n=n, q=q)
    host_srs = gp.SRS.new(7 * n + 6, x=rng.randrange(2, gp.P), alpha=rng.randrange(2, gp.P))
    return circuit, assignment, host_srs, gp.Randomness.generate(rng, m=q)


def _prove_ranks(rank, world, store, outdir):
    mesh = init_rank(rank, world, store)
    from sonic_tpu_torch import golden_protocol as gp
    from sonic_tpu_torch import protocol, serial
    from sonic_tpu_torch.circuit import random_circuit
    from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
    from sonic_tpu_torch.parallel import ntt_sharded
    from sonic_tpu_torch.srs import SRS

    sharded_ntts = []
    real = ntt_sharded.poly_mul_ntt_sharded

    def counted(a, b, m):
        sharded_ntts[-1] += 1
        return real(a, b, m)

    ntt_sharded.poly_mul_ntt_sharded = counted
    out = []
    for n, q, seed, threshold in CASES:
        if threshold:
            os.environ["SONIC_TPU_NTT_THRESHOLD"] = threshold
        circuit, assignment, host_srs, rnd = _setup(random.Random(seed), n, q, random_circuit, gp)
        srs = SRS.from_host(host_srs, device="cpu")
        dc = DeviceCircuit.from_host(circuit, device="cpu")
        sharded_ntts.append(0)
        proof, oracle = protocol.prove(srs, DeviceAssignment.from_host(assignment, device="cpu"),
                                       dc, rnd, mesh=mesh)
        ok = protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
        out.append((serial.proof_to_bytes(proof), oracle.y, oracle.z, ok, sharded_ntts[-1]))
        os.environ.pop("SONIC_TPU_NTT_THRESHOLD", None)
    if world == 2:  # the first circuit again, given as sparse rows
        from sonic_tpu_torch.sparse import CsrRows

        circuit, assignment, host_srs, rnd = _setup(random.Random(CASES[0][2]), *CASES[0][:2], random_circuit, gp)
        srs = SRS.from_host(host_srs, device="cpu")
        w = circuit.weights
        dc = DeviceCircuit.from_rows(*(CsrRows.from_dense(m) for m in (w.wL, w.wR, w.wO)), circuit.cs,
                                     device="cpu")
        proof, oracle = protocol.prove(srs, DeviceAssignment.from_host(assignment, device="cpu"), dc, rnd,
                                       mesh=mesh)
        ok = protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
        out.append((serial.proof_to_bytes(proof), oracle.y, oracle.z, ok))
    save_rank(outdir, rank, out)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_prove_equals_the_single_device_oracle(world, tmp_path):
    wait = run_world(_prove_ranks, world, tmp_path)

    from sonic_tpu import golden_protocol as jgp
    from sonic_tpu import serial as jserial
    from sonic_tpu.circuit import random_circuit as jrandom_circuit

    want = []
    for n, q, seed, _ in CASES:
        circuit, assignment, host_srs, rnd = _setup(random.Random(seed), n, q, jrandom_circuit, jgp)
        proof, oracle = jgp.prove(host_srs, assignment, circuit, rnd)
        want.append((jserial.proof_to_bytes(proof), oracle.y, oracle.z))
    for rank, out in enumerate(wait()):
        for (n, q, _, threshold), got, (pbytes, y, z) in zip(CASES, out, want):
            assert got[:3] == (pbytes, y, z), (rank, n, q)
            assert got[3] is True, (rank, n, q)
            # the t product took the sharded four-step NTT exactly under the threshold
            assert got[4] == (1 if threshold else 0), (rank, n, q)
        if world == 2:
            assert out[len(CASES)] == want[0] + (True,), rank
