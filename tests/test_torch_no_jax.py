"""PyTorch port: it runs without jax, and its host copies stay copies.

(a) A fresh interpreter imports sonic_tpu_torch, proves and verifies the
    pinned example2 vector and runs the example CLI on a random circuit;
    afterwards neither jax nor sonic_tpu is in sys.modules.
(b) Each host module the port carries as a JAX-free copy matches its
    original in sonic_tpu line for line, apart from import lines and the
    docstring that marks it a copy. native.py may differ only in
    `_find_lib`; serial.py holds a subset of the original's top-level
    definitions, each unchanged.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_SCRIPT = r"""
import json, sys
from sonic_tpu_torch import golden_protocol as gp, protocol, serial
from sonic_tpu_torch.circuit import example_circuit_2
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.srs import SRS
from sonic_tpu_torch import example

vec = json.load(open("tests/vectors/pinned_v1.json"))["example2"]
r = vec["rnd"]
rnd = gp.Randomness(cns=r["cns"], y=r["y"], z=r["z"], ys=r["ys"], zs=r["zs"], u=r["u"], v=r["v"])
circuit, assignment = example_circuit_2(x=1, z=2)
srs = SRS.from_host(gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"]))
dc = DeviceCircuit.from_host(circuit)
proof, oracle = protocol.prove(srs, DeviceAssignment.from_host(assignment), dc, rnd)
assert serial.proof_to_bytes(proof).hex() == vec["proof_hex"]
assert protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
assert example.main(["--n", "6", "--q", "2", "--seed", "3"]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sonic_tpu"))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_proves_and_verifies_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Success: True" in res.stdout and "NO_JAX_OK" in res.stdout


def _module(path):
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    return src, ast.parse(src)


def _is_import(node) -> bool:
    return isinstance(node, (ast.Import, ast.ImportFrom))


def _body_lines(src: str, tree: ast.Module, skip=()) -> list:
    """Source lines after the module docstring, without import statements
    and without the top-level definitions named in `skip`."""
    lines = src.splitlines()
    drop = set(range(tree.body[0].end_lineno))  # the docstring
    for node in tree.body:
        if _is_import(node) or getattr(node, "name", None) in skip:
            drop.update(range(node.lineno - 1, node.end_lineno))
    return [line for i, line in enumerate(lines) if i not in drop]


FULL_COPIES = ["fields/constants.py", "circuit.py", "golden.py", "golden_protocol.py",
               "pairing/host.py", "native.py"]


@pytest.mark.parametrize("path", FULL_COPIES)
def test_host_copy_matches_its_original(path):
    osrc, otree = _module(os.path.join("sonic_tpu", path))
    csrc, ctree = _module(os.path.join("sonic_tpu_torch", path))
    skip = {"_find_lib"} if path == "native.py" else ()
    assert _body_lines(csrc, ctree, skip) == _body_lines(osrc, otree, skip)
    # the copy's docstring says it is a copy and keeps the original's
    doc = ast.get_docstring(ctree, clean=False)
    assert doc.startswith("JAX-free copy of `sonic_tpu/")
    assert doc.endswith(ast.get_docstring(otree, clean=False))


def test_serial_copy_is_a_subset_of_the_original():
    osrc, otree = _module("sonic_tpu/serial.py")
    csrc, ctree = _module("sonic_tpu_torch/serial.py")

    def segments(src, tree):
        out = {}
        for node in tree.body[1:]:
            if _is_import(node):
                continue
            names = [node.name] if hasattr(node, "name") else [
                t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)
            ]
            for name in names:
                out[name] = ast.get_source_segment(src, node)
        return out

    orig, copy = segments(osrc, otree), segments(csrc, ctree)
    for name in ("fr_to_bytes", "fr_from_bytes", "g1_to_bytes", "g1_from_bytes",
                 "proof_to_bytes", "proof_from_bytes"):
        assert name in copy
    for name, seg in copy.items():
        assert orig.get(name) == seg, name
