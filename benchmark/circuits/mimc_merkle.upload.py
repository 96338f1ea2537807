"""The family's own upload: the sparse rows go up once, through
`DeviceCircuit.from_rows` (only the nonzeros: rows, columns and the
weights that are not 1), and each witness's circuit shares them, with its
own cs (its roots)."""
from __future__ import annotations

import dataclasses

from sonic_tpu_torch.constraints import DeviceCircuit
from sonic_tpu_torch.fields.limb import FR


def upload(rows, witnesses, config, device) -> list:
    dc = DeviceCircuit.from_rows(*rows, witnesses[0].cs, device=device)
    return [dc] + [dataclasses.replace(dc, cs=FR.from_int(w.cs, device=device)) for w in witnesses[1:]]
