"""PyTorch port, sharded batch proving: protocol.prove_batch(mesh=...) at
B=2, n=4, q=2 in gloo worlds of 2 and 4 ranks, every rank's proofs equal,
as `serial` bytes, to the port's single-rank prove_batch on the same
inputs, and each proof verifying.

No jax or sonic_tpu import at the top level: the ranks import this module.
"""
import random

import pytest
import torch

from test_torch_parallel import init_rank, run_world, save_rank

torch.set_num_threads(1)

B, N, Q, SEED = 2, 4, 2, 23


def _inputs(device="cpu"):
    from sonic_tpu_torch import golden_protocol as gp
    from sonic_tpu_torch.circuit import random_circuit
    from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
    from sonic_tpu_torch.srs import SRS

    rng = random.Random(SEED)
    host_srs = gp.SRS.new(7 * N + 6, x=rng.randrange(2, gp.P), alpha=rng.randrange(2, gp.P))
    pairs = [random_circuit(rng, n=N, q=Q) for _ in range(B)]
    rnds = [gp.Randomness.generate(rng, m=Q) for _ in range(B)]
    return (SRS.from_host(host_srs, device=device),
            [DeviceAssignment.from_host(a, device=device) for _, a in pairs],
            [DeviceCircuit.from_host(c, device=device) for c, _ in pairs], rnds)


def _batch_ranks(rank, world, store, outdir):
    mesh = init_rank(rank, world, store)
    from sonic_tpu_torch import protocol, serial

    srs, das, dcs, rnds = _inputs()
    batch = protocol.prove_batch(srs, das, dcs, rnds, mesh=mesh)
    ok = [protocol.verify(srs, dc, p, o.y, o.z, o.yzs) for dc, (p, o) in zip(dcs, batch)]
    save_rank(outdir, rank, ([serial.proof_to_bytes(p) for p, _ in batch], ok))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_prove_batch_equals_prove_batch(world, tmp_path):
    wait = run_world(_batch_ranks, world, tmp_path)

    from sonic_tpu_torch import protocol, serial

    want = [serial.proof_to_bytes(p) for p, _ in protocol.prove_batch(*_inputs())]
    for rank, (got, ok) in enumerate(wait()):
        assert got == want, rank
        assert ok == [True] * B, rank
