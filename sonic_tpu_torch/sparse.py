"""A circuit's weight matrices as sparse constraint rows, on the host.

`circuit.GateWeights` holds each of wL, wR and wO as Q x n Python lists,
which a real circuit cannot afford: with about two linear constraints a
gate, Q = 2^17 and n = 2^16 make 2^33 entries a matrix, nearly all zero.
`CsrRows` holds one matrix as compressed sparse rows, and
`constraints.DeviceCircuit.from_rows` puts three of them on the device.
(`circuit.py` stays a line-for-line copy of the JAX package's module.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .fields.constants import R_MOD


@dataclasses.dataclass
class CsrRows:
    """One Q x n weight matrix: row q's nonzeros lie in columns
    cols[indptr[q]:indptr[q+1]], with the weights vals[...] of the same
    slice, ints taken mod P (a column named twice in a row adds up)."""

    n: int
    indptr: np.ndarray  # (Q + 1,) int64, from 0 up to the number of nonzeros
    cols: np.ndarray  # (nnz,) int64 in [0, n)
    vals: np.ndarray  # (nnz,) ints, any dtype that holds them

    @property
    def q(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def from_dense(cls, rows) -> "CsrRows":
        """A Q x n matrix (lists of rows of ints) -> its nonzeros."""
        a = np.array(rows, dtype=object).reshape(len(rows), -1) % R_MOD
        q, i = np.nonzero(a)
        indptr = np.zeros(a.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(q, minlength=a.shape[0]), out=indptr[1:])
        return cls(a.shape[1], indptr, i.astype(np.int64), a[q, i])
