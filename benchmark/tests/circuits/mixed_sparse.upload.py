"""The test family's own upload: every weight goes up as a Python int
through `FR.from_int`, one dense (Q, n) list of rows a matrix."""
from __future__ import annotations

import dataclasses

from sonic_tpu_torch.circuit import ArithCircuit, GateWeights
from sonic_tpu_torch.constraints import DeviceCircuit
from sonic_tpu_torch.fields.limb import FR


def upload(rows, witnesses, config, device) -> list:
    mats = []
    for r in rows:
        m = [[0] * r.n for _ in range(r.q)]
        for q in range(r.q):
            for i in range(r.indptr[q], r.indptr[q + 1]):
                m[q][int(r.cols[i])] = int(r.vals[i])
        mats.append(m)
    dc = DeviceCircuit.from_host(ArithCircuit(GateWeights(*mats), witnesses[0].cs), device=device)
    return [dataclasses.replace(dc, cs=FR.from_int(w.cs, device=device)) for w in witnesses]
