"""JAX-free copy of `sonic_tpu/circuit.py`. Below this docstring the code is
the original's, line for line; its relative imports resolve inside the port.

`sonic_tpu/__init__.py` imports jax whenever any of its submodules is
imported, and `sonic_tpu/` stays as it is, so the port carries its own
copy of this host module.

Original docstring:

Arithmetic-circuit types (Bulletproofs constraint system).

Equivalent of the reference's `bulletproofs` dependency types
(Bulletproofs.ArithmeticCircuit — SURVEY.md §2.3): the Sonic code reads only
`weights` (wL/wR/wO) and `cs`; the commitment-weights field is carried but
never used (grep of reference src/). Host-side representation: Python-int
matrices; `to_device` produces Montgomery limb arrays for the TPU path.

Constraint system (Bootle et al. / reference Constraints.hs):
  - n multiplication gates: aL * aR = aO   (componentwise)
  - Q linear constraints:   wL aL + wR aR + wO aO = cs
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .fields.constants import R_MOD


@dataclasses.dataclass
class GateWeights:
    """wL, wR, wO: Q x n matrices over Fr (lists of rows of ints)."""

    wL: Sequence[Sequence[int]]
    wR: Sequence[Sequence[int]]
    wO: Sequence[Sequence[int]]

    @property
    def n(self) -> int:
        return len(self.wL[0]) if self.wL else 0

    @property
    def q(self) -> int:
        return len(self.wL)


@dataclasses.dataclass
class Assignment:
    """Wire assignment: three n-vectors with aL * aR = aO."""

    aL: Sequence[int]
    aR: Sequence[int]
    aO: Sequence[int]

    @property
    def n(self) -> int:
        return len(self.aL)


@dataclasses.dataclass
class ArithCircuit:
    """weights + cs (+ unused commitment-weights field for API parity with
    bulletproofs' ArithCircuit — never read by Sonic)."""

    weights: GateWeights
    cs: Sequence[int]
    commitment_weights: object = None


def example_circuit_1(x: int, z: int) -> tuple[ArithCircuit, Assignment]:
    """Reference test/Test/Reference.hs:38-50 (1 mul gate, 2 linear)."""
    w = GateWeights(wL=[[1], [0]], wR=[[0], [1]], wO=[[0], [0]])
    cs = [7 + 3, 2 + 10]
    aL = [10]
    aR = [12]
    aO = [aL[0] * aR[0] % R_MOD]
    return ArithCircuit(w, cs), Assignment(aL, aR, aO)


def example_circuit_2(x: int, z: int) -> tuple[ArithCircuit, Assignment]:
    """Reference examples/Main.hs:38-63 == test/Test/Reference.hs:65-90
    (2 mul gates, 5 linear): proves (4-z)(9-z) = (9-z)(4-z)."""
    w = GateWeights(
        wL=[[0, 0], [1, 0], [0, 1], [0, 0], [0, 0]],
        wR=[[0, 0], [0, 0], [0, 0], [1, 0], [0, 1]],
        wO=[[1, -1 % R_MOD], [0, 0], [0, 0], [0, 0], [0, 0]],
    )
    cs = [0, (4 - z) % R_MOD, (9 - z) % R_MOD, (9 - z) % R_MOD, (4 - z) % R_MOD]
    aL = [(4 - z) % R_MOD, (9 - z) % R_MOD]
    aR = [(9 - z) % R_MOD, (4 - z) % R_MOD]
    aO = [l * r % R_MOD for l, r in zip(aL, aR)]
    return ArithCircuit(w, cs), Assignment(aL, aR, aO)


def random_circuit(rng, n: int | None = None, q: int | None = None):
    """Random satisfiable circuit, mirroring the reference's QuickCheck
    generators (test/Test/Reference.hs:125-169): one-hot weight rows, cs
    derived from the assignment so the instance is satisfiable."""
    if n is None:
        n = rng.randrange(1, 21)
    if q is None:
        q = rng.randrange(1, n + 1)
    aL = [rng.randrange(R_MOD) for _ in range(n)]
    aR = [rng.randrange(R_MOD) for _ in range(n)]
    aO = [l * r % R_MOD for l, r in zip(aL, aR)]

    def gen_w():
        rows = [[0] * n for _ in range(q)]
        pos = rng.randrange(q)
        rows[pos] = [1] * n
        return rows

    wL, wR, wO = gen_w(), gen_w(), gen_w()
    cs = [
        (
            sum(w * a for w, a in zip(wL[qq], aL))
            + sum(w * a for w, a in zip(wR[qq], aR))
            + sum(w * a for w, a in zip(wO[qq], aO))
        )
        % R_MOD
        for qq in range(q)
    ]
    return ArithCircuit(GateWeights(wL, wR, wO), cs), Assignment(aL, aR, aO)
