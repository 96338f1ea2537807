"""Carry the JAX package's state across to the port.

Everything here takes numpy arrays (what `np.asarray` gives for a JAX
array) and never imports jax. Field elements keep the JAX layout: (..., L)
16-bit limbs in Montgomery form; only the dtype changes (uint32 -> int64).

    srs(d, g_x, g_ax, h_x, h_ax)           device SRS (tables as (x, y, inf))
    circuit(wL, wR, wO, cs)                DeviceCircuit
    assignment(aL, aR, aO)                 DeviceAssignment
"""
from __future__ import annotations

import numpy as np
import torch

from .constraints import DeviceAssignment, DeviceCircuit
from .curve.group import Affine
from .fields.limb import FQ
from .srs import SRS


def limbs(a, device=None) -> torch.Tensor:
    """A uint32 limb array -> the port's int64 limb tensor, value for value."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def affine(x, y, inf, device=None) -> Affine:
    return Affine(
        limbs(x, device), limbs(y, device), torch.from_numpy(np.array(inf, bool)).to(device)
    )


def g2_rows(x, y, inf) -> list:
    """A G2 Affine table as numpy arrays (x, y: (rows, 2, 24) Montgomery Fq2
    limbs, c0 then c1; inf: (rows,)) -> host affine points, None = infinity."""
    x0, x1 = FQ.to_int(np.asarray(x)[:, 0]), FQ.to_int(np.asarray(x)[:, 1])
    y0, y1 = FQ.to_int(np.asarray(y)[:, 0]), FQ.to_int(np.asarray(y)[:, 1])
    return [
        None if flag else ((int(x0[i]), int(x1[i])), (int(y0[i]), int(y1[i])))
        for i, flag in enumerate(np.asarray(inf, bool))
    ]


def srs(d: int, g_x, g_ax, h_x, h_ax, device=None) -> SRS:
    """A JAX device SRS (full mode) -> the port's SRS.

    g_x, g_ax: (x, y, inf) numpy arrays of the G1 tables; h_x, h_ax: the G2
    tables as (x, y, inf) arrays, kept as host points."""
    return SRS(
        d,
        affine(*g_x, device=device),
        affine(*g_ax, device=device),
        g2_rows(*h_x),
        g2_rows(*h_ax),
    )


def circuit(wL, wR, wO, cs, device=None) -> DeviceCircuit:
    return DeviceCircuit(limbs(wL, device), limbs(wR, device), limbs(wO, device), limbs(cs, device))


def assignment(aL, aR, aO, device=None) -> DeviceAssignment:
    return DeviceAssignment(limbs(aL, device), limbs(aR, device), limbs(aO, device))
