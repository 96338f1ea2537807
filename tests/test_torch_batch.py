"""PyTorch port, batch proving: the proof-batch builders of
sonic_tpu_torch.constraints vs sonic_tpu.constraints (limb for limb), and
protocol.prove_batch vs the port's single prove and the golden prover
(proof bytes), at the shapes of tests/test_prove_batch.py, whole and with
the helper streamed over slices of the proofs. All comparisons are exact.
"""
import collections
import random

import numpy as np
import pytest
import torch

from sonic_tpu import constraints as jcons
from sonic_tpu import golden_protocol as jgp
from sonic_tpu import serial as jserial
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu_torch import breakdown, budget, constraints, protocol, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import random_circuit
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.fields.limb import FR
from sonic_tpu_torch.srs import SRS

torch.set_num_threads(1)

N, Q, B = 3, 2, 3


def assert_same(jax_array, tensor):
    assert np.array_equal(np.asarray(jax_array).astype(np.int64), tensor.numpy())


def _setup(rng, B, q=Q):
    host_srs = gp.SRS.new(7 * N + 5, x=rng.randrange(2, gp.P), alpha=rng.randrange(2, gp.P))
    circuits, assignments, rnds = [], [], []
    for _ in range(B):
        c, a = random_circuit(rng, n=N, q=q)
        circuits.append(c)
        assignments.append(a)
        rnds.append(gp.Randomness.generate(rng, m=q))
    return host_srs, circuits, assignments, rnds


def test_batch_builders_match_jax():
    rng = random.Random(77)
    _, circuits, assignments, rnds = _setup(rng, B)
    jc = jcons.stack_circuits([jcons.DeviceCircuit.from_host(c) for c in circuits])
    ja = jcons.stack_assignments([jcons.DeviceAssignment.from_host(a) for a in assignments])
    tc = constraints.stack_circuits([DeviceCircuit.from_host(c, device="cpu") for c in circuits])
    ta = constraints.stack_assignments([DeviceAssignment.from_host(a, device="cpu") for a in assignments])
    for f in ("wL", "wR", "wO", "cs"):
        assert_same(getattr(jc, f), getattr(tc, f))
    for f in ("aL", "aR", "aO"):
        assert_same(getattr(ja, f), getattr(ta, f))
    assert (tc.n, tc.q, ta.n) == (N, Q, N)

    seeds = np.random.default_rng(5)

    def fr_batch(*shape):
        vals = [int.from_bytes(seeds.bytes(32), "little") % gp.P for _ in range(int(np.prod(shape)))]
        j = JFR.from_int(vals).reshape(shape + (16,))
        return j, torch.from_numpy(np.asarray(j).astype(np.int64))

    (jcns, tcns), (jys, tys), (jus, tus) = fr_batch(B, 4), fr_batch(B), fr_batch(B)
    jr1, tr1 = jcons.r_x1_batch(ja, jcns), constraints.r_x1_batch(ta, tcns)
    assert_same(jr1, tr1)
    off = -(2 * N + 4)
    assert_same(jcons.r_at_y_batch(jr1, jys, off), constraints.r_at_y_batch(tr1, tys, off))
    assert_same(jcons.s_at_y_batch(jc, jys), constraints.s_at_y_batch(tc, tys))
    assert_same(jcons.s_at_u_batch(jc, jus), constraints.s_at_u_batch(tc, tus))
    assert_same(jcons.k_at_y_batch(jc, N, jys), constraints.k_at_y_batch(tc, N, tys))


def test_prove_batch_matches_single_proofs_and_golden(monkeypatch):
    """Each of the B proofs equals the port's prove and the golden prove
    byte for byte and verifies; the batch finishes its B(4m+7) MSMs in
    one combine_windows, under the breakdown's phase timers."""
    rng = random.Random(77)
    host_srs, circuits, assignments, rnds = _setup(rng, B)
    srs = SRS.from_host(host_srs, device="cpu")
    dcs = [DeviceCircuit.from_host(c, device="cpu") for c in circuits]
    das = [DeviceAssignment.from_host(a, device="cpu") for a in assignments]
    combines = []
    real = protocol.combine_windows

    def counting(parts):
        combines.append(sum(p.totals.x[..., 0, 0].numel() for p in parts))
        return real(parts)

    monkeypatch.setattr(protocol, "combine_windows", counting)
    with breakdown.phase_timers(torch.device("cpu"), breakdown.PHASES + breakdown.BATCH_PHASES) as acc:
        batch = protocol.prove_batch(srs, das, dcs, rnds)
    assert combines == [B * (4 * Q + 7)]
    monkeypatch.undo()
    # every batch phase timer was reached, and the window combine once
    assert {label for _, _, label in breakdown.BATCH_PHASES} <= set(acc)
    assert acc["window combine, all MSMs"][1] == 1
    for b in range(B):
        proof, oracle = batch[b]
        single, oracle_s = protocol.prove(srs, das[b], dcs[b], rnds[b])
        want, _ = jgp.prove(host_srs, assignments[b], circuits[b], jgp.Randomness(**vars(rnds[b])))
        assert serial.proof_to_bytes(proof) == serial.proof_to_bytes(single)
        assert serial.proof_to_bytes(proof) == jserial.proof_to_bytes(want)
        assert (oracle.y, oracle.z, oracle.yzs) == (oracle_s.y, oracle_s.z, oracle_s.yzs)
        assert protocol.verify(srs, dcs[b], proof, oracle.y, oracle.z, oracle.yzs)


def test_prove_batch_raises_on_a_violating_assignment():
    rng = random.Random(78)
    host_srs, circuits, assignments, rnds = _setup(rng, 2, q=1)
    srs = SRS.from_host(host_srs, device="cpu")
    dcs = [DeviceCircuit.from_host(c, device="cpu") for c in circuits]
    das = [DeviceAssignment.from_host(a, device="cpu") for a in assignments]
    bad = das[1]
    das[1] = DeviceAssignment(bad.aL, bad.aR, FR.from_int([v + 1 for v in assignments[1].aO]))
    with pytest.raises(IndexError, match="g\\^alpha is not in the SRS"):
        protocol.prove_batch(srs, das, dcs, rnds)


def test_streamed_prove_batch_matches_single_proofs_and_golden(monkeypatch):
    """B = 2 proofs with the helper's unit at a whole step over one proof's
    coefficients: the helper streams over 2 slices of one proof (counted
    by protocol.helper_slicings) while the other steps stay whole, and
    each proof equals the port's single prove and the golden prover byte
    for byte. Smaller budgets slice the proofs as evenly as they allow."""
    rng = random.Random(79)
    host_srs, circuits, assignments, rnds = _setup(rng, 2)
    srs = SRS.from_host(host_srs, device="cpu")
    dcs = [DeviceCircuit.from_host(c, device="cpu") for c in circuits]
    das = [DeviceAssignment.from_host(a, device="cpu") for a in assignments]
    assert protocol._helper_slices(2, Q, N) == [(0, 2)]
    one = Q * (3 * N + 1)  # coefficients of one proof's helper instances
    monkeypatch.setattr(budget, "HELPER_BYTES", budget.STEP_BYTES // one)
    assert protocol._helper_slices(2, Q, N) == [(0, 1), (1, 2)]
    assert protocol._helper_slices(5, Q, N) == [(i, i + 1) for i in range(5)]
    monkeypatch.setattr(budget, "HELPER_BYTES", budget.STEP_BYTES // (2 * one))
    assert protocol._helper_slices(5, Q, N) == [(0, 1), (1, 3), (3, 5)]
    assert protocol._helper_slices(4, Q, N) == [(0, 2), (2, 4)]
    monkeypatch.setattr(budget, "HELPER_BYTES", budget.STEP_BYTES // one)
    before = collections.Counter(protocol.helper_slicings)
    batch = protocol.prove_batch(srs, das, dcs, rnds)
    assert protocol.helper_slicings - before == {(2, 2): 1}
    for b in range(2):
        single, _ = protocol.prove(srs, das[b], dcs[b], rnds[b])
        want, _ = jgp.prove(host_srs, assignments[b], circuits[b], jgp.Randomness(**vars(rnds[b])))
        assert serial.proof_to_bytes(batch[b][0]) == serial.proof_to_bytes(single) == jserial.proof_to_bytes(want)
