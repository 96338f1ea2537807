"""The circuit families and the reference over sparse rows: the default
family gives the very inputs the one-hot generator gave before families
existed (a frozen copy of it below), the reference's proofs at a tiny size
are pinned, and Omega, s, k and the satisfying cs over sparse rows agree
with plain loops over dense matrices. Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark import gen, reference  # noqa: E402

P = gen.P
SEEDS = [2**31 + 977, 3513000103]


# --- the one-hot generator as it was before circuit families, frozen ---

def frozen_weights(seed, c, n, q):
    r = gen.rng(seed, "weights", c)
    w = np.zeros((3, q, n), np.int64)
    for k in range(3):
        w[k, r.randrange(q)] = 1
    return w


def frozen_weight_rows(w):
    out = []
    for mat in w:
        rows = []
        for row in mat:
            idx = np.flatnonzero(row)
            rows.append((idx, [int(v) for v in row[idx]]))
        out.append(rows)
    return out


def _frozen_dot(rows, vals):
    return [sum(wv * vals[i] for i, wv in zip(idx.tolist(), ws)) % P for idx, ws in rows]


def frozen_witness(seed, c, k, w):
    r = gen.rng(seed, "witness", c, k)
    n = w.shape[2]
    aL = [r.randrange(P) for _ in range(n)]
    aR = [r.randrange(P) for _ in range(n)]
    aO = [a * b % P for a, b in zip(aL, aR)]
    rows = frozen_weight_rows(w)
    cs = [(x + y + z) % P for x, y, z in zip(_frozen_dot(rows[0], aL), _frozen_dot(rows[1], aR), _frozen_dot(rows[2], aO))]
    return aL, aR, aO, cs


# ---

def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def dense(rows):
    """A family's rows as a (Q, n) object matrix of ints."""
    m = np.zeros((rows.q, rows.n), dtype=object)
    for q in range(rows.q):
        for i in range(rows.indptr[q], rows.indptr[q + 1]):
            m[q, rows.cols[i]] = rows.vals[i]
    return m


def _well_formed(rows):
    assert rows.indptr[0] == 0 and rows.indptr[-1] == rows.cols.size == rows.vals.size
    assert (np.diff(rows.indptr) >= 0).all()
    for q in range(rows.q):
        cols = rows.cols[rows.indptr[q]:rows.indptr[q + 1]]
        assert (np.diff(cols) > 0).all() and ((cols >= 0) & (cols < rows.n)).all()
    assert all(0 < int(v) < P for v in rows.vals)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,traffic", [("n16q64", "prove_verify"), ("n16q8-b16", "batch")])
def test_random_one_hot_gives_the_inputs_of_the_frozen_generator(name, traffic, seed):
    """At each configuration's own size: every circuit's rows and its whole
    witness pool."""
    config = _config(name)
    with open(os.path.join(BENCH, "traffic", traffic + ".json")) as f:
        pool = json.load(f)["witness_pool"]
    assert gen.circuit_name(config) == "random_one_hot"
    assert gen.helper_instances(config) == config["linear_constraints"]
    fam = gen.family(config)
    n, q = config["gates"], config["linear_constraints"]
    for c in range(config.get("batch", 1)):
        rows = fam.rows(seed, c, config)
        want = frozen_weights(seed, c, n, q)
        for k in range(3):
            _well_formed(rows[k])
            row = int(np.flatnonzero(want[k].any(axis=1))[0])
            assert np.array_equal(np.diff(rows[k].indptr), np.where(np.arange(q) == row, n, 0))
            assert np.array_equal(rows[k].cols, np.arange(n)) and all(v == 1 for v in rows[k].vals)
        for k in range(pool):
            w = fam.witness(seed, c, k, config, rows)
            assert (w.aL, w.aR, w.aO, w.cs) == frozen_witness(seed, c, k, want)


# sha256 of repr(reference.expected(...)) below, worked out by the
# reference as it was before circuit families (dense weights, loops over rows)
PINNED = {"prove": "40c6af6d07c047ca2a575e28365ad717855abf5116c4e41c42394bb27a2bfbad",
          "batch": "e637134cb5522df497920607d2aea0e56947715a10b766f57a08372395e58c2d"}


@pytest.mark.parametrize("kind", ["prove", "batch"])
def test_the_references_proofs_are_pinned_at_a_tiny_size(kind):
    config = dict(_config("n16q64"), gates=8, linear_constraints=2, d=76)
    seed = 2**31 + 977
    if kind == "prove":
        jobs = [(0, k % 2, gen.randomness(seed, "window", k, 2)) for k in range(3)]
    else:
        jobs = [(c, k % 2, gen.randomness(seed, "window", 2 * k + c, 2)) for k in range(2) for c in range(2)]
    got = reference.expected(seed, config, jobs, 1)
    assert hashlib.sha256(repr(got).encode()).hexdigest() == PINNED[kind]


def _mixed(q, n):
    fam = gen.load(os.path.join(HERE, "circuits", "mixed_sparse.py"), "mixed_sparse")
    config = {"gates": n, "linear_constraints": q, "d": 7 * n + 20}
    return fam, config


@pytest.mark.parametrize("q,n", [(40, 16), (3, 16), (1, 4)])
def test_sums_over_nonzeros_equal_loops_over_dense_matrices(q, n):
    """Omega, s(a, b), k(y) and the satisfying cs, over the test family's
    rows (Q > n too; empty rows, several entries a row, weights P - 1),
    against plain loops over the dense matrices."""
    fam, config = _mixed(q, n)
    seed = SEEDS[0]
    rows = fam.rows(seed, 0, config)
    for r in rows:
        _well_formed(r)
    wl, wr, wo = (dense(r) for r in rows)
    wit = fam.witness(seed, 0, 0, config, rows)
    for j in range(q):
        lhs = sum(wl[j, i] * wit.aL[i] + wr[j, i] * wit.aR[i] + wo[j, i] * wit.aO[i] for i in range(n))
        assert lhs % P == wit.cs[j]
    cir = reference.Circuit(rows)
    rnd = gen.randomness(seed, "window", 0, 1)
    a, b = rnd.z, rnd.y
    ai = pow(a, -1, P)
    om = [sum(wl[j, i] * pow(ai, i + 1, P) + wr[j, i] * pow(a, i + 1, P) + wo[j, i] * pow(a, i + 1 + n, P)
              for i in range(n)) % P for j in range(q)]
    assert cir.omega(a).tolist() == om
    g = sum(pow(a * b, i, P) + pow(a * pow(b, -1, P), i, P) for i in range(1, n + 1))
    s = (sum(pow(b, n + 1 + j, P) * om[j] for j in range(q)) - pow(a, n, P) * g) % P
    assert cir.s(cir.omega(a), a, b) == s
    assert reference.over_q(wit.cs, b, n) == sum(c * pow(b, n + 1 + j, P) for j, c in enumerate(wit.cs)) % P
