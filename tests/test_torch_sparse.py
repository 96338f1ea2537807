"""PyTorch port, circuits given as sparse constraint rows
(`DeviceCircuit.from_rows`) against their dense twins (`from_host` of the
same matrices):

(a) the builders s(X, y) (ys (m, L), and stacked circuits with ys (B, L)
    and (B, m, L)), s(u, Y) and k(y) give the same integers, with the
    nonzeros cut into slices of a few terms, on a random circuit
    with Q > n, empty rows, a column named twice in a row, and weights 1,
    2, 3, 7 and P - 1; `constraints.row_terms` counts the terms gathered;
    `limb.reduce_sums` is exact at the most terms it takes in a test's
    time, and `_weights` gives `FR.from_int`'s limbs for any ints;
(b) example2 given as sparse rows: `prove` and `prove_batch` give the
    pinned proof bytes (the dense path's and the golden prover's) and the
    golden prover's for a second cs of the same pattern, `verify` checks
    them, and a batch of two patterns is refused, as is
    `fiat_shamir.prove_device` on a sparse circuit. `prove(mesh=)` on a
    sparse circuit: tests/test_torch_parallel_prove.py.

A prove on the CPU costs ~15 s of one core at any n (plain-torch field
inversions and MSMs), so the proves are few.
"""
import json
import os
import random

import numpy as np
import pytest
import torch

from sonic_tpu_torch import budget, constraints, fiat_shamir, native, protocol, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import ArithCircuit, GateWeights, example_circuit_2
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.fields import limb
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FR
from sonic_tpu_torch.sparse import CsrRows
from sonic_tpu_torch.srs import SRS

torch.set_num_threads(1)

P = R_MOD
with open(os.path.join(os.path.dirname(__file__), "vectors", "pinned_v1.json")) as f:
    VECTORS = json.load(f)
WEIGHTS = (1, 2, 3, 7, P - 1)


def random_rows(rng, n, q):
    """wL, wR, wO as CsrRows: every fourth row empty, up to four entries
    a row, and a column named twice in some rows."""
    out = []
    for _ in range(3):
        indptr, cols, vals = [0], [], []
        for row in range(q):
            width = 0 if row % 4 == 1 else rng.randint(1, 4)
            picked = sorted(rng.choice(range(n)) for _ in range(width))
            cols += picked
            vals += [rng.choice(WEIGHTS) for _ in picked]
            indptr.append(len(cols))
        out.append(CsrRows(n, np.array(indptr), np.array(cols), np.array(vals, dtype=object)))
    return out


def to_dense(rows):
    """A CsrRows as a Q x n list of rows of ints (a column named twice adds up)."""
    out = [[0] * rows.n for _ in range(rows.q)]
    for q in range(rows.q):
        for i in range(rows.indptr[q], rows.indptr[q + 1]):
            out[q][int(rows.cols[i])] = (out[q][int(rows.cols[i])] + int(rows.vals[i])) % P
    return out


def twins(rows, cs):
    """(sparse, dense) DeviceCircuits of the same matrices and cs."""
    sparse = DeviceCircuit.from_rows(*rows, cs, device="cpu")
    dense = DeviceCircuit.from_host(ArithCircuit(GateWeights(*(to_dense(r) for r in rows)), cs), device="cpu")
    return sparse, dense


def fr(rng, *shape):
    return FR.from_int(np.array([rng.randrange(1, P) for _ in range(int(np.prod(shape)))],
                                dtype=object).reshape(shape))


def test_sparse_builders_equal_the_dense_ones(monkeypatch):
    """With the nonzeros cut into slices of 3 terms (at m = 3 ys): the
    slices' sums are exact, so the result is the whole build's."""
    rng = random.Random(41)
    n, q, m = 8, 20, 3
    rows = random_rows(rng, n, q)
    cs = [[rng.randrange(P) for _ in range(q)] for _ in range(2)]
    sp, dn = zip(*(twins(rows, c) for c in cs))
    assert (sp[0].n, sp[0].q, sp[0].device) == (dn[0].n, dn[0].q, dn[0].device)
    monkeypatch.setattr(budget, "STEP_BYTES", 3 * m * budget.TERM_BYTES)
    ys = fr(rng, m)
    us, y2, ys2 = fr(rng), fr(rng, 2), fr(rng, 2, m)
    E = sp[0].rows.row.numel()
    assert E == sum(int((np.asarray(r.vals) % P != 0).sum()) for r in rows)
    before = constraints.row_terms
    assert torch.equal(constraints.s_at_y_batch(sp[0], ys), constraints.s_at_y_batch(dn[0], ys))
    assert constraints.row_terms - before == E * m
    assert torch.equal(constraints.s_at_u_batch(sp[0], us), constraints.s_at_u_batch(dn[0], us))
    assert torch.equal(constraints.k_at_y(sp[0], n, us), constraints.k_at_y(dn[0], n, us))
    ssp, sdn = constraints.stack_circuits(list(sp)), constraints.stack_circuits(list(dn))
    assert ssp.rows is sp[0].rows and ssp.cs.shape == sdn.cs.shape
    for y in (y2, ys2):
        assert torch.equal(constraints.s_at_y_batch(ssp, y), constraints.s_at_y_batch(sdn, y))
    assert torch.equal(constraints.s_at_u_batch(ssp, y2), constraints.s_at_u_batch(sdn, y2))
    assert torch.equal(constraints.k_at_y_batch(ssp, n, y2), constraints.k_at_y_batch(sdn, n, y2))


def test_reduce_sums_is_exact_at_many_terms():
    """2^16 + 3 elements (a thousand of them P - 1) summed into one entry
    by `index_add_`, so its limb columns pass 2^32, and a few into others."""
    rng = random.Random(5)
    vals = [P - 1] * 1000 + [rng.randrange(P) for _ in range(2**16 + 3 - 1000)] + [5, 0, P - 2]
    into = torch.tensor([0] * (2**16 + 3) + [1, 2, 2])
    acc = torch.zeros(3, FR.nlimbs, dtype=torch.int64).index_add_(0, into, FR.from_int(vals))
    want = [sum(vals[: 2**16 + 3]) % P, 5, (P - 2) % P]
    assert [int(v) for v in FR.to_int(limb.reduce_sums(acc, FR))] == want


def test_weights_go_up_as_from_int_s_limbs():
    rng = random.Random(9)
    small = [[rng.randrange(2) for _ in range(5)] for _ in range(3)]
    big = [[rng.choice([0, 1, P - 1, -1, 2**63, P + 4, rng.randrange(P)]) for _ in range(5)] for _ in range(3)]
    for w in (small, big):
        assert torch.equal(constraints._weights(w, "cpu"), FR.from_int(w))
    flat = [P - 1, 2, 2**64 + 3, 7]
    assert torch.equal(constraints._weights(np.array(flat, dtype=object), "cpu"), FR.from_int(flat))


def _native_g1_mul(p, k):
    return native.g1_msm_native([p], [k % P])


def test_example2_as_sparse_rows_gives_the_pinned_proof_through_prove_and_prove_batch(monkeypatch):
    """example2 (q = 5 > n = 2, an empty row, weight P - 1) as sparse rows:
    `prove` and the first proof of a `prove_batch` give the pinned bytes,
    which the dense path and the golden prover give (test_torch_protocol);
    the batch's second circuit shares the pattern with another cs, and
    its proof is the golden prover's (its G1 multiplications taken by the
    native library, as test_torch_protocol's golden prover's)."""
    vec = VECTORS["example2"]
    circuit, assignment = example_circuit_2(x=1, z=2)
    other, assignment2 = example_circuit_2(x=1, z=5)
    w = circuit.weights
    rows = [CsrRows.from_dense(m) for m in (w.wL, w.wR, w.wO)]
    assert (rows[0].q, rows[0].n) == (5, 2) and [to_dense(r) for r in rows] == [w.wL, w.wR, w.wO]
    host = gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"])
    srs = SRS.from_host(host, device="cpu")
    dcs = [DeviceCircuit.from_rows(*rows, c.cs, device="cpu") for c in (circuit, other)]
    das = [DeviceAssignment.from_host(a, device="cpu") for a in (assignment, assignment2)]
    r = vec["rnd"]
    rnds = [gp.Randomness(r["cns"], r["y"], r["z"], r["ys"], r["zs"], r["u"], r["v"]),
            gp.Randomness.generate(random.Random(3), vec["m"])]
    proof, oracle = protocol.prove(srs, das[0], dcs[0], rnds[0])
    assert serial.proof_to_bytes(proof).hex() == vec["proof_hex"]
    assert protocol.verify(srs, dcs[0], proof, oracle.y, oracle.z, oracle.yzs) is True
    proof.pr_a = (proof.pr_a + 1) % P
    assert protocol.verify(srs, dcs[0], proof, oracle.y, oracle.z, oracle.yzs) is False
    with pytest.raises(ValueError, match="sparse rows"):
        fiat_shamir.prove_device(srs, das[0], dcs[0], rnds[0].cns)

    got = protocol.prove_batch(srs, das, dcs, rnds)
    monkeypatch.setattr(gp.gc, "g1_mul", _native_g1_mul)
    want, _ = gp.prove(host, assignment2, other, rnds[1])
    assert serial.proof_to_bytes(got[0][0]).hex() == vec["proof_hex"]
    assert serial.proof_to_bytes(got[1][0]) == serial.proof_to_bytes(want)
    p1, o1 = got[1]
    assert protocol.verify(srs, dcs[1], p1, o1.y, o1.z, o1.yzs) is True
    mixed = [dcs[0], DeviceCircuit.from_rows(rows[1], rows[0], rows[2], other.cs, device="cpu")]
    with pytest.raises(ValueError, match="one pattern"):
        protocol.prove_batch(srs, das, mixed, rnds)
    dense = DeviceCircuit.from_host(circuit, device="cpu")
    with pytest.raises(ValueError, match="one pattern"):
        constraints.stack_circuits([dcs[0], dense])
