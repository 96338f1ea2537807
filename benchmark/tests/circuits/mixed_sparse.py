"""A circuit family for the tests only: Q may exceed n; a row holds zero
to four nonzeros at distinct columns, every fifth row none, with weights
drawn from 1, 2, 3, 7 and P - 1 (that is, -1)."""
from __future__ import annotations

import numpy as np

from benchmark import gen

WEIGHTS = (1, 2, 3, 7, gen.P - 1)


def rows(seed: int, c: int, config: dict) -> tuple:
    n, q = config["gates"], config["linear_constraints"]
    r = gen.rng(seed, "weights", c)
    out = []
    for _ in range(3):
        indptr, cols, vals = [0], [], []
        for row in range(q):
            width = 0 if row % 5 == 2 else r.randint(1, 4)
            cols += sorted(r.sample(range(n), width))
            vals += [r.choice(WEIGHTS) for _ in range(width)]
            indptr.append(len(cols))
        out.append(gen.Rows(n, np.array(indptr, np.int64), np.array(cols, np.int64), np.array(vals, dtype=object)))
    return tuple(out)


def witness(seed: int, c: int, k: int, config: dict, rows: tuple) -> gen.Witness:
    r = gen.rng(seed, "witness", c, k)
    n = config["gates"]
    aL = [r.randrange(gen.P) for _ in range(n)]
    aR = [r.randrange(gen.P) for _ in range(n)]
    aO = [a * b % gen.P for a, b in zip(aL, aR)]
    return gen.Witness(aL, aR, aO, gen.satisfying_cs(rows, aL, aR, aO))
