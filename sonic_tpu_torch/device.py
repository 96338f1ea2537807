"""Where the port's public constructors put their tensors.

`SRS.new`, `SRS.from_host`, `DeviceCircuit.from_host` / `from_rows`,
`DeviceAssignment.from_host` and `convert.srs/circuit/assignment` take
`device=None` to mean the card. On a machine without one they raise; they
never fall back to the CPU. The CPU tests pass `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None (raises if there is none)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sonic_tpu_torch: no CUDA device (torch.cuda.is_available() is False); "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
