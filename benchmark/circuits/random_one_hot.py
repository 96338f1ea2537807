"""The random one-hot circuits of the reference's QuickCheck generator
(Sonic's test/Test/Reference.hs:125-169, `random_circuit` in the port):
each of wL, wR and wO is a Q x n matrix whose one row, drawn at random,
is all ones; aL and aR are uniform in Fr, aO = aL * aR, and cs is derived
from the witness, so every instance is satisfiable. The weights and the
witnesses are drawn apart, so one circuit serves a pool of witnesses.

Q is the configuration's "linear_constraints", n its "gates".
"""
from __future__ import annotations

import numpy as np

from benchmark import gen


def rows(seed: int, c: int, config: dict) -> tuple:
    """Circuit c's (wL, wR, wO) as `gen.Rows`: one row of n ones each."""
    n, q = config["gates"], config["linear_constraints"]
    r = gen.rng(seed, "weights", c)
    out = []
    for _ in range(3):
        indptr = np.zeros(q + 1, np.int64)
        indptr[r.randrange(q) + 1:] = n
        out.append(gen.Rows(n, indptr, np.arange(n, dtype=np.int64), np.ones(n, dtype=object)))
    return tuple(out)


def witness(seed: int, c: int, k: int, config: dict, rows: tuple) -> gen.Witness:
    """Witness k of circuit c, and the cs that makes it satisfy `rows`."""
    r = gen.rng(seed, "witness", c, k)
    n = config["gates"]
    aL = [r.randrange(gen.P) for _ in range(n)]
    aR = [r.randrange(gen.P) for _ in range(n)]
    aO = [a * b % gen.P for a, b in zip(aL, aR)]
    return gen.Witness(aL, aR, aO, gen.satisfying_cs(rows, aL, aR, aO))
