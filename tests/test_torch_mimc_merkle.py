"""The benchmark's MiMC Merkle circuit family (`benchmark/circuits/
mimc_merkle.py`) and its cell on the CPU:

(c) at a test size (depth 2, 1 or 2 paths, the rounds cut to 3) every gate
    has aL aR = aO, every constraint row equals cs, and the rows count the
    linear constraints the configuration states;
(d) at the full 322 rounds and depth 1 the circuit's output is bellman's
    MiMC of the level's inputs in the bit's order, and meets the root;
(e) a wrong sibling or a flipped bit breaks a constraint;
(f) `run_cell` of `prove.mimc-merkle32`, cut to the test size, is correct
    with the family's sparse upload, and a negated point in the window's
    proof is caught. A prove on the CPU costs ~15 s of one core, so the
    two runs share one SRS and one proof.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import gen, harness  # noqa: E402

P = gen.P
Q_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
SEED = 2**31 + 977
FAM = gen.family({"circuit": "mimc_merkle"})


def config(paths=1, depth=2, rounds=3, spare=3):
    """The family's keys at a test size: 4 rounds + 3 constraints a level
    (the first level's link to a last one stands for the path's root);
    `spare` zero gates."""
    n = paths * depth * (2 * rounds + 2) + spare
    return {"gates": n, "depth": depth, "paths": paths, "rounds": rounds,
            "linear_constraints": paths * depth * (4 * rounds + 3)}


def satisfies(rows, aL, aR, aO, cs) -> bool:
    gates = all(a * b % P == o for a, b, o in zip(aL, aR, aO))
    return gates and gen.satisfying_cs(rows, aL, aR, aO) == cs


@pytest.mark.parametrize("paths", [1, 2])
def test_every_gate_and_constraint_holds_at_a_test_size(paths):
    cfg = config(paths)
    rows = FAM.rows(SEED, 0, cfg)
    assert rows[0].q == cfg["linear_constraints"] and rows[0].n == cfg["gates"]
    widths = np.sum([np.diff(r.indptr) for r in rows], axis=0)
    assert 2 <= widths.min() and widths.max() <= 5
    assert set(np.concatenate([r.vals for r in rows]).tolist()) == {1, 2, P - 1}
    for k in range(2):
        w = FAM.witness(SEED, 0, k, cfg, rows)
        assert satisfies(rows, w.aL, w.aR, w.aO, w.cs)
        assert w.aL[-3:] == w.aR[-3:] == w.aO[-3:] == [0, 0, 0]
    with open(os.path.join(ROOT, "benchmark", "configs", "mimc-merkle32-n16.json")) as f:
        full = json.load(f)
    wrong = dict(cfg, linear_constraints=cfg["linear_constraints"] + 1)
    with pytest.raises(ValueError, match="linear constraints"):
        FAM.rows(SEED, 0, wrong)
    assert FAM.Layout(full).used == full["gates_used"] <= full["gates"]


@pytest.mark.parametrize("bit", [0, 1])
def test_the_output_is_bellmans_mimc_at_322_rounds(bit):
    cfg = config(depth=1, rounds=322, spare=0)
    consts = FAM.constants(SEED, 0, cfg)
    assert len(consts) == 322
    leaf, sib = 12345, P - 7
    aL, aR, aO = FAM.assign(cfg, consts, [(leaf, [sib], [bit])])
    out = (aO[2 * 322 - 1] + aL[2 * 320] - consts[320]) % P
    xl, xr = (sib, leaf) if bit else (leaf, sib)
    for c in consts:  # bellman's loop, written out again
        xl, xr = (pow(xl + c, 3, P) + xr) % P, xl
    assert out == xl == FAM.root(leaf, [sib], [bit], consts)
    rows = FAM.rows(SEED, 0, cfg)
    assert satisfies(rows, aL, aR, aO, FAM.public_cs(cfg, consts, [xl]))


@pytest.mark.parametrize("fault", ["sibling", "bit"])
def test_a_wrong_sibling_or_a_flipped_bit_breaks_a_constraint(fault):
    cfg = config(paths=2)
    rows = FAM.rows(SEED, 0, cfg)
    consts = FAM.constants(SEED, 0, cfg)
    inputs = FAM.draw(SEED, 0, 0, cfg)
    cs = FAM.witness(SEED, 0, 0, cfg, rows).cs
    leaf, sibs, bits = inputs[1]
    if fault == "sibling":
        sibs = [sibs[0], (sibs[1] + 1) % P]
    else:
        bits = [1 - bits[0], bits[1]]
    wires = FAM.assign(cfg, consts, [inputs[0], (leaf, sibs, bits)])
    assert all(a * b % P == o for a, b, o in zip(*wires))
    assert gen.satisfying_cs(rows, *wires) != cs


def _negated(proof):
    x, y = proof.pr_r
    return dataclasses.replace(proof, pr_r=(x, (-y) % Q_MOD))


def test_the_cell_runs_correct_and_a_negated_point_is_caught(monkeypatch):
    from sonic_tpu_torch import protocol

    spec = harness.load_spec("prove.mimc-merkle32")
    assert harness.load_upload(spec.config) is not harness.upload_dense
    cfg = config()
    spec.config.update(cfg, d=7 * cfg["gates"] + 20, helper_instances=2)
    torch.set_num_threads(1)
    # this process has jax loaded (tests/conftest.py); benchmark/tests
    # hold the harness to loading none
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    # one SRS and one proof between the two runs: the warm-up asks for the
    # window's proof, and each is made once and kept
    jobs, new, prove = harness.Cell.jobs, harness.SRS.new, protocol.prove
    kept = {}

    def srs_once(*args, **kwargs):
        if "srs" not in kept:
            kept["srs"] = new(*args, **kwargs)
        return kept["srs"]

    def prove_once(srs, da, dc, rnd, mesh=None):
        if rnd.y not in kept:
            kept[rnd.y] = prove(srs, da, dc, rnd, mesh=mesh)
        return kept[rnd.y]

    monkeypatch.setattr(harness.Cell, "jobs", lambda self, what, k: jobs(self, "window", k))
    monkeypatch.setattr(harness.SRS, "new", srs_once)
    monkeypatch.setattr(protocol, "prove", prove_once)
    res = harness.run_cell(spec, SEED, 0.0, False, "cpu", workers=1)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 1, res["checks"]
    assert res["checks"]["verify_false"]["value"] == 0 and {"setup_s", "prove_s", "verify_s"} <= set(res["metrics"])
    (y,) = [k for k in kept if k != "srs"]
    kept[y] = (_negated(kept[y][0]), kept[y][1])
    res = harness.run_cell(spec, SEED, 0.0, False, "cpu", workers=1)
    assert not res["correct"] and res["checks"]["mismatched_elements"]["value"] == 1
    assert res["checks"]["verify_false"]["value"] == 1
