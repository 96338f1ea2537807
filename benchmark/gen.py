"""Every input of a cell, made from `--seed`: the trapdoor, the circuits'
weights, a pool of witnesses for each circuit and each request's
randomness.

The circuits follow the reference's QuickCheck generator (Sonic's
test/Test/Reference.hs:125-169, `random_circuit` in the port): each of
wL, wR and wO is a Q x n matrix whose one row, drawn at random, is all
ones; aL and aR are uniform in Fr, aO = aL * aR, and cs is derived from
the witness, so every instance is satisfiable. Here the weights and the
witnesses are drawn apart, so one circuit serves a pool of witnesses.

Each stream is its own `random.Random`, seeded by a string of the seed
and what it draws, so any seed (a large one too) gives the same inputs in
every process, and a draw for one request never shifts another's.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np

# the scalar field of BLS12-381
P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def _rng(seed: int, *what) -> random.Random:
    return random.Random(":".join(str(w) for w in (seed,) + what))


def trapdoor(seed: int) -> tuple[int, int]:
    """(x, alpha) of the SRS."""
    r = _rng(seed, "trapdoor")
    return r.randrange(2, P), r.randrange(2, P)


def weights(seed: int, c: int, n: int, q: int) -> np.ndarray:
    """Circuit c's (wL, wR, wO) as one (3, q, n) int64 array of 0/1."""
    r = _rng(seed, "weights", c)
    w = np.zeros((3, q, n), np.int64)
    for k in range(3):
        w[k, r.randrange(q)] = 1
    return w


def weight_rows(w: np.ndarray) -> list:
    """For each of the 3 matrices and each row q, (column indices, weights)
    of the nonzero entries."""
    out = []
    for mat in w:
        rows = []
        for row in mat:
            idx = np.flatnonzero(row)
            rows.append((idx, [int(v) for v in row[idx]]))
        out.append(rows)
    return out


@dataclasses.dataclass
class Witness:
    aL: list
    aR: list
    aO: list
    cs: list


def _dot(rows, vals) -> list:
    return [sum(wv * vals[i] for i, wv in zip(idx.tolist(), ws)) % P for idx, ws in rows]


def witness(seed: int, c: int, k: int, w: np.ndarray) -> Witness:
    """Witness k of circuit c, and the cs that makes it satisfy the
    circuit's weights `w`."""
    r = _rng(seed, "witness", c, k)
    n = w.shape[2]
    aL = [r.randrange(P) for _ in range(n)]
    aR = [r.randrange(P) for _ in range(n)]
    aO = [a * b % P for a, b in zip(aL, aR)]
    rows = weight_rows(w)
    cs = [(x + y + z) % P for x, y, z in zip(_dot(rows[0], aL), _dot(rows[1], aR), _dot(rows[2], aO))]
    return Witness(aL, aR, aO, cs)


@dataclasses.dataclass
class Rnd:
    """A proof's randomness: 4 blinding scalars, the challenges y and z,
    the helper's m pairs (y_j, z_j), and u and v; all in [1, P)."""

    cns: list
    y: int
    z: int
    ys: list
    zs: list
    u: int
    v: int


def randomness(seed: int, what: str, k: int, m: int) -> Rnd:
    r = _rng(seed, "randomness", what, k)

    def f():
        return r.randrange(1, P)

    return Rnd([f() for _ in range(4)], f(), f(), [f() for _ in range(m)], [f() for _ in range(m)], f(), f())
