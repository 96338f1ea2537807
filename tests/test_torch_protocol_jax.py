"""PyTorch port against sonic_tpu.protocol.prove: the same SRS and circuit,
carried across by convert.py as numpy arrays, and the same randomness give
the same proof bytes; the port's verify says True, and False on a tampered
proof (compared as booleans: pcv_batch draws fresh randomness).

Kept apart from test_torch_protocol.py because sonic_tpu's XLA:CPU compiles
take most of this file's time.
"""
import json
import os
import random

import numpy as np
import torch

from sonic_tpu import golden_protocol as jgp
from sonic_tpu import protocol as jprotocol
from sonic_tpu import serial as jserial
from sonic_tpu.constraints import DeviceAssignment as JDA
from sonic_tpu.constraints import DeviceCircuit as JDC
from sonic_tpu.srs import SRS as JSRS
from sonic_tpu_torch import convert, protocol, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import example_circuit_2

torch.set_num_threads(1)

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "pinned_v1.json")


def test_example2_matches_sonic_tpu_prove():
    """The SRS is example2's pinned one; circuit and randomness are fresh."""
    with open(VEC_PATH) as f:
        vec = json.load(f)["example2"]
    rng = random.Random(42)
    x, z = (rng.randrange(1, gp.P) for _ in range(2))
    circuit, assignment = example_circuit_2(x, z)
    d = vec["d"]
    jsrs = JSRS.from_host(gp.SRS.new(d, x=vec["x"], alpha=vec["alpha"]))
    jc, ja = JDC.from_host(circuit), JDA.from_host(assignment)
    rnd = jgp.Randomness.generate(rng, circuit.weights.q)
    want, _ = jprotocol.prove(jsrs, ja, jc, rnd)

    def table(t):
        return np.asarray(t.x), np.asarray(t.y), np.asarray(t.inf)

    srs = convert.srs(d, table(jsrs.g_x), table(jsrs.g_ax), table(jsrs.h_x), table(jsrs.h_ax))
    dc = convert.circuit(*(np.asarray(a) for a in (jc.wL, jc.wR, jc.wO, jc.cs)))
    da = convert.assignment(*(np.asarray(a) for a in (ja.aL, ja.aR, ja.aO)))
    got, oracle = protocol.prove(srs, da, dc, gp.Randomness(**vars(rnd)))
    assert serial.proof_to_bytes(got) == jserial.proof_to_bytes(want)
    assert protocol.verify(srs, dc, got, oracle.y, oracle.z, oracle.yzs) is True
    got.pr_a = (got.pr_a + 1) % gp.P
    assert protocol.verify(srs, dc, got, oracle.y, oracle.z, oracle.yzs) is False
