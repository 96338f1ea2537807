"""Carry the JAX package's state across to the port.

Everything here takes numpy arrays (what `np.asarray` gives for a JAX
array) and never imports jax. Field elements keep the JAX layout: (..., L)
16-bit limbs in Montgomery form; only the dtype changes (uint32 -> int64).
`srs`, `circuit` and `assignment` put their tensors on the card unless
`device` says otherwise.

    srs(d, g_x, g_ax, h_x, h_ax)           device SRS, all four tables (x, y, inf)
    circuit(wL, wR, wO, cs)                DeviceCircuit
    assignment(aL, aR, aO)                 DeviceAssignment
"""
from __future__ import annotations

import numpy as np
import torch

from .constraints import DeviceAssignment, DeviceCircuit
from .curve.group import Affine
from .device import resolve
from .srs import SRS


def limbs(a, device=None) -> torch.Tensor:
    """A uint32 limb array -> the port's int64 limb tensor, value for value."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def affine(x, y, inf, device=None) -> Affine:
    return Affine(
        limbs(x, device), limbs(y, device), torch.from_numpy(np.array(inf, bool)).to(device)
    )


def srs(d: int, g_x, g_ax, h_x, h_ax, device=None) -> SRS:
    """A JAX device SRS (full mode) -> the port's SRS, all four tables on
    `device`. Each table is an (x, y, inf) triple of numpy arrays: G1
    coordinates (rows, 24), G2 coordinates (rows, 2, 24), c0 then c1."""
    device = resolve(device)
    return SRS(d, *(affine(*t, device=device) for t in (g_x, g_ax, h_x, h_ax)))


def circuit(wL, wR, wO, cs, device=None) -> DeviceCircuit:
    device = resolve(device)
    return DeviceCircuit(limbs(wL, device), limbs(wR, device), limbs(wO, device), limbs(cs, device))


def assignment(aL, aR, aO, device=None) -> DeviceAssignment:
    device = resolve(device)
    return DeviceAssignment(limbs(aL, device), limbs(aR, device), limbs(aO, device))
