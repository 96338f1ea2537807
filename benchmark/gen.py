"""Every input of a cell, made from `--seed`: the trapdoor, the circuits
(by the configuration's circuit family), a pool of witnesses for each
circuit and each request's randomness.

A configuration names its family with the key "circuit" (default
"random_one_hot"); the family is `circuits/<name>.py`, loaded by path
(`family`). It gives each circuit's three Q x n weight matrices as sparse
rows (`Rows`) and witnesses that satisfy them (`Witness`); `satisfying_cs`
works out the cs that makes a witness satisfy its rows. The helper's
number of instances m is the key "helper_instances" (default
"linear_constraints": `helper_instances`).

Each stream is its own `random.Random`, seeded by a string of the seed
and what it draws, so any seed (a large one too) gives the same inputs in
every process, and a draw for one request never shifts another's.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import os
import random

import numpy as np

# the scalar field of BLS12-381
P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
CIRCUITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "circuits")


def rng(seed: int, *what) -> random.Random:
    return random.Random(":".join(str(w) for w in (seed,) + what))


def trapdoor(seed: int) -> tuple[int, int]:
    """(x, alpha) of the SRS."""
    r = rng(seed, "trapdoor")
    return r.randrange(2, P), r.randrange(2, P)


def load(path: str, name: str):
    """The module in the file at `path`, loaded by path under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def circuit_name(config: dict) -> str:
    return config.get("circuit", "random_one_hot")


def family(config: dict):
    """The configuration's circuit family: `CIRCUITS/<name>.py`, which
    gives `rows(seed, c, config)` and `witness(seed, c, k, config, rows)`."""
    name = circuit_name(config)
    return load(os.path.join(CIRCUITS, name + ".py"), f"benchmark_circuit_{name}")


def helper_instances(config: dict) -> int:
    """m, the instances the helper aggregates in a proof."""
    return config.get("helper_instances", config["linear_constraints"])


@dataclasses.dataclass
class Rows:
    """One Q x n weight matrix as sparse rows (CSR): row q's nonzeros lie
    in columns cols[indptr[q]:indptr[q+1]] with the weights vals[...] of
    the same slice, ints in [0, P) (-1 is P - 1)."""

    n: int
    indptr: np.ndarray  # (Q + 1,) int64, from 0 up to nnz
    cols: np.ndarray  # (nnz,) int64 in [0, n)
    vals: np.ndarray  # (nnz,) object

    @property
    def q(self) -> int:
        return self.indptr.size - 1

    @functools.cached_property
    def _layout(self) -> tuple:
        """(the entries whose weight is not 1, the rows that are not empty)"""
        return np.flatnonzero(self.vals != 1), np.flatnonzero(np.diff(self.indptr))

    def products(self, vec: np.ndarray) -> np.ndarray:
        """[sum_i w[q, i] vec[i] for each row q] as an object array, not
        reduced mod P; vec is an object array of n ints."""
        scaled, filled = self._layout
        terms = vec[self.cols]
        terms[scaled] = terms[scaled] * self.vals[scaled]
        out = np.zeros(self.q, dtype=object)
        if filled.size:
            out[filled] = np.add.reduceat(terms, self.indptr[filled])
        return out


@dataclasses.dataclass
class Witness:
    aL: list
    aR: list
    aO: list
    cs: list


def satisfying_cs(rows: tuple, aL: list, aR: list, aO: list) -> list:
    """cs_q = (wL aL + wR aR + wO aO)_q mod P: the cs with which the
    witness satisfies the circuit's rows (wL, wR, wO)."""
    acc = sum(r.products(np.array(a, dtype=object)) for r, a in zip(rows, (aL, aR, aO)))
    return [int(v) % P for v in acc]


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
    r = rng(seed, "randomness", what, k)

    def f():
        return r.randrange(1, P)

    return Rnd([f() for _ in range(4)], f(), f(), [f() for _ in range(m)], [f() for _ in range(m)], f(), f())
