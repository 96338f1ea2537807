"""Numerical sanitizer: canonical-form checks over int64 limb tensors.

Port of `sonic_tpu/utils/sanitize.py`, with its messages. The failure mode
it guards against is silent carry or range corruption in limb arithmetic:

  - every limb in [0, 2^16)
  - the value below the field's modulus

The checks fetch the tensor to the host and walk it in Python: for tests
and debug runs, never the hot path. `SONIC_TPU_DEBUG=1` turns
`debug_check_canonical` into a hard check; otherwise it is a no-op.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..fields import constants as C
from ..fields.limb import FieldSpec


def is_enabled() -> bool:
    return os.environ.get("SONIC_TPU_DEBUG", "") not in ("", "0")


def assert_canonical(arr, spec: FieldSpec, what: str = "value") -> None:
    """Raise if any element has a limb outside [0, 2^16) or a value >= modulus."""
    a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    a = a.astype(np.int64)
    if a.shape[-1] != spec.nlimbs:
        raise AssertionError(
            f"{what}: limb axis {a.shape[-1]} != {spec.nlimbs} ({spec.name})"
        )
    if (a > C.LIMB_MASK).any() or (a < 0).any():
        raise AssertionError(f"{what}: non-canonical limb >= 2^{C.LIMB_BITS}")
    for row in a.reshape(-1, spec.nlimbs):
        v = C.limbs_to_int(row)
        if v >= spec.modulus:
            raise AssertionError(
                f"{what}: value {hex(v)} >= {spec.name} modulus"
            )


def debug_check_canonical(arr, spec: FieldSpec, what: str = "value") -> None:
    """assert_canonical, active only under SONIC_TPU_DEBUG=1."""
    if is_enabled():
        assert_canonical(arr, spec, what)
