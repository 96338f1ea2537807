"""Merkle-tree membership proofs hashed with MiMC, the circuit of a
shielded pool's spend: `paths` paths of `depth` levels, each checked
against its own public root.

The hash is the MiMC Feistel permutation "LongsightF322p3" (Albrecht et
al., eprint 2016/492) as bellman's tests/mimc.rs proves it: `rounds`
rounds of xL, xR <- xR + (xL + C_i)^3, xL, the output xL, the constants
drawn from a seeded generator. A level hashes (cur, sibling), or
(sibling, cur) when its path bit is 1, as a Sapling note commitment tree
does (depth 32, Zcash protocol spec 5.3).

Gates, for each path and level in turn (t_i = xL_i + C_i):
  A_i = (t_i, t_i, t_i^2) and B_i = (t_i^2, t_i, t_i^3) for each round i,
  then bit = (b, b, b) and swap = (b, e, d), e = sibling - cur, d = b e,
  so that the hash's input is xL = cur + d, xR = cur + e - d. The gates
  that are left over are zero gates.
Linear constraints (wL aL + wR aR + wO aO = cs), for each round: A's two
inputs equal, B's inputs copies of A's output and input, and t_i carried
from the round before (t_i = t_{i-1}^3 + t_{i-2} - C_{i-2} + C_i, round 1
through the swap gate); for each level: b^2 = b in two constraints, the
swap gate's b, and the level's input tied to the last level's output, or,
after the last level, the output equal to the path's root. The constants
and the roots are in cs; every weight is 1, P - 1 or 2.

The configuration gives "gates" (n), "linear_constraints" (Q, checked
against the circuit), "depth", "paths" and "rounds". Witness k draws each
path's leaf, siblings and bits from the seed; the roots come from `mimc`
over Python ints.
"""
from __future__ import annotations

import numpy as np

from benchmark import gen

P = gen.P
L, R, O = 0, 1, 2  # wL, wR, wO


def mimc(xl: int, xr: int, consts: list) -> int:
    """bellman's `mimc`: xL, xR <- xR + (xL + C)^3, xL for each constant C."""
    for c in consts:
        xl, xr = (pow(xl + c, 3, P) + xr) % P, xl
    return xl


def constants(seed: int, c: int, config: dict) -> list:
    """The round constants of circuit c."""
    r = gen.rng(seed, "mimc", c)
    return [r.randrange(P) for _ in range(config["rounds"])]


def root(leaf: int, siblings: list, bits: list, consts: list) -> int:
    cur = leaf
    for s, b in zip(siblings, bits):
        cur = mimc(s, cur, consts) if b else mimc(cur, s, consts)
    return cur


class Layout:
    """Where each path's and level's gates lie, and the constraints."""

    def __init__(self, config: dict):
        self.n, self.depth = config["gates"], config["depth"]
        self.paths, self.rounds = config["paths"], config["rounds"]
        if self.rounds < 2:
            raise ValueError("mimc_merkle: the carry of xL needs 2 rounds or more")
        self.level = 2 * self.rounds + 2  # gates a level: A_i, B_i, then bit, swap
        self.used = self.paths * self.depth * self.level
        if self.used > self.n:
            raise ValueError(f"mimc_merkle: {self.used} gates used, {self.n} in the circuit")

    def base(self, p: int, lv: int) -> int:
        return (p * self.depth + lv) * self.level

    def constraints(self):
        """Each row's entries [(matrix, gate, weight)] and its cs as
        ([(coefficient, round)] of the constants, the path whose root it
        adds or None)."""
        Rn = self.rounds
        for p in range(self.paths):
            for lv in range(self.depth):
                g = self.base(p, lv)
                A = [g + 2 * i for i in range(Rn)]
                B = [g + 2 * i + 1 for i in range(Rn)]
                bit, swap = g + 2 * Rn, g + 2 * Rn + 1
                for i in range(Rn):
                    yield [(L, A[i], 1), (R, A[i], -1)], ([], None)
                    yield [(L, B[i], 1), (O, A[i], -1)], ([], None)
                    yield [(R, B[i], 1), (L, A[i], -1)], ([], None)
                    if i == 1:  # t_1 = t_0^3 + xR_0 + C_1, xR_0 = t_0 - C_0 + e - 2d
                        yield ([(L, A[1], 1), (O, B[0], -1), (L, A[0], -1), (R, swap, -1), (O, swap, 2)],
                               ([(1, 1), (-1, 0)], None))
                    elif i > 1:
                        yield [(L, A[i], 1), (O, B[i - 1], -1), (L, A[i - 2], -1)], ([(1, i), (-1, i - 2)], None)
                yield [(L, bit, 1), (R, bit, -1)], ([], None)
                yield [(O, bit, 1), (L, bit, -1)], ([], None)
                yield [(L, swap, 1), (L, bit, -1)], ([], None)
                if lv:  # t_0 = cur + d + C_0, cur the last level's output t_{R-1}^3 + t_{R-2} - C_{R-2}
                    prev = self.base(p, lv - 1)
                    yield ([(L, A[0], 1), (O, swap, -1), (O, prev + 2 * Rn - 1, -1), (L, prev + 2 * Rn - 4, -1)],
                           ([(1, 0), (-1, Rn - 2)], None))
            last = self.base(p, self.depth - 1)
            yield [(O, last + 2 * Rn - 1, 1), (L, last + 2 * Rn - 4, 1)], ([(1, Rn - 2)], p)


def rows(seed: int, c: int, config: dict) -> tuple:
    """(wL, wR, wO) as `gen.Rows`; the same for every seed and circuit."""
    lay = Layout(config)
    ents = [[[], [0]] for _ in range(3)]  # (entries, row pointers) of each matrix
    q = 0
    for entries, _ in lay.constraints():
        for k in range(3):
            ents[k][0] += sorted((g, w % P) for m, g, w in entries if m == k)
            ents[k][1].append(len(ents[k][0]))
        q += 1
    if q != config["linear_constraints"]:
        raise ValueError(f"mimc_merkle: the circuit has {q} linear constraints, the config says "
                         f"{config['linear_constraints']}")
    out = []
    for entries, indptr in ents:
        cols = np.array([g for g, _ in entries], np.int64)
        vals = np.array([w for _, w in entries], dtype=object)
        out.append(gen.Rows(lay.n, np.array(indptr, np.int64), cols, vals))
    return tuple(out)


def draw(seed: int, c: int, k: int, config: dict) -> list:
    """Witness k's (leaf, siblings, bits) of each path."""
    r = gen.rng(seed, "witness", c, k)
    d = config["depth"]
    return [(r.randrange(P), [r.randrange(P) for _ in range(d)], [r.randrange(2) for _ in range(d)])
            for _ in range(config["paths"])]


def assign(config: dict, consts: list, inputs: list) -> tuple:
    """The gates' (aL, aR, aO) for each path's (leaf, siblings, bits)."""
    lay = Layout(config)
    aL, aR, aO = ([0] * lay.n for _ in range(3))
    for p, (leaf, siblings, bits) in enumerate(inputs):
        cur = leaf
        for lv, (s, b) in enumerate(zip(siblings, bits)):
            g = lay.base(p, lv)
            e = (s - cur) % P
            d = b * e
            bit, swap = g + 2 * lay.rounds, g + 2 * lay.rounds + 1
            aL[bit], aR[bit], aO[bit] = b, b, b
            aL[swap], aR[swap], aO[swap] = b, e, d
            xl, xr = (cur + d) % P, (cur + e - d) % P
            for i, ci in enumerate(consts):
                t = (xl + ci) % P
                t2 = t * t % P
                t3 = t2 * t % P
                aL[g + 2 * i], aR[g + 2 * i], aO[g + 2 * i] = t, t, t2
                aL[g + 2 * i + 1], aR[g + 2 * i + 1], aO[g + 2 * i + 1] = t2, t, t3
                xl, xr = (t3 + xr) % P, xl
            cur = xl
    return aL, aR, aO


def public_cs(config: dict, consts: list, roots: list) -> list:
    """cs: each row's terms of the round constants, and the roots."""
    return [(sum(a * consts[i] for a, i in terms) + (roots[p] if p is not None else 0)) % P
            for _, (terms, p) in Layout(config).constraints()]


def witness(seed: int, c: int, k: int, config: dict, rows: tuple) -> gen.Witness:
    """Witness k of circuit c: the gates of its paths, and cs with each
    path's root worked out by `mimc` apart from the gates."""
    consts = constants(seed, c, config)
    inputs = draw(seed, c, k, config)
    aL, aR, aO = assign(config, consts, inputs)
    roots = [root(leaf, sib, bits, consts) for leaf, sib, bits in inputs]
    return gen.Witness(aL, aR, aO, public_cs(config, consts, roots))
