"""PyTorch port: it runs without jax, and its host copies stay copies.

(a) A fresh interpreter imports sonic_tpu_torch (its multichip entry
    point too), proves and verifies the pinned example2 vector, runs the
    example CLI on a random circuit, proves a batch of two, builds a full
    SRS and round-trips it through a
    checkpoint, and proves with the Fiat-Shamir device prover; another
    imports parallel/ and utils/ too and proves in a 2-rank gloo world
    with a mesh (each rank's proof equal to the single-rank one), where it
    also runs the example CLI; afterwards neither jax nor sonic_tpu is in
    sys.modules.
(b) Each host module the port carries as a JAX-free copy matches its
    original in sonic_tpu line for line, apart from import lines and the
    docstring that marks it a copy. native.py may differ only in
    `_find_lib`; serial.py and fiat_shamir.py hold a subset of the
    original's top-level definitions, each unchanged, beside the functions
    they rewrite for torch.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_SCRIPT = r"""
import json, os, random, sys, tempfile
from sonic_tpu_torch import fiat_shamir, golden_protocol as gp, protocol, serial
from sonic_tpu_torch.circuit import example_circuit_2, random_circuit
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.srs import SRS
from sonic_tpu_torch import example, multichip

vec = json.load(open("tests/vectors/pinned_v1.json"))["example2"]
r = vec["rnd"]
rnd = gp.Randomness(cns=r["cns"], y=r["y"], z=r["z"], ys=r["ys"], zs=r["zs"], u=r["u"], v=r["v"])
circuit, assignment = example_circuit_2(x=1, z=2)
srs = SRS.from_host(gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"]), device="cpu")
dc = DeviceCircuit.from_host(circuit, device="cpu")
proof, oracle = protocol.prove(srs, DeviceAssignment.from_host(assignment, device="cpu"), dc, rnd)
assert serial.proof_to_bytes(proof).hex() == vec["proof_hex"]
assert protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
assert example.main(["--device", "cpu", "--n", "6", "--q", "2", "--seed", "3"]) == 0

rng = random.Random(5)
pairs = [random_circuit(rng, n=1, q=1) for _ in range(2)]
rnds = [gp.Randomness.generate(rng, m=1) for _ in pairs]
host_srs = gp.SRS.new(16, x=rng.randrange(2, gp.P), alpha=rng.randrange(2, gp.P))
srs = SRS.from_host(host_srs, device="cpu")
dcs = [DeviceCircuit.from_host(c, device="cpu") for c, _ in pairs]
das = [DeviceAssignment.from_host(a, device="cpu") for _, a in pairs]
batch = protocol.prove_batch(srs, das, dcs, rnds)
for dc, (p, o) in zip(dcs, batch):
    assert protocol.verify(srs, dc, p, o.y, o.z, o.yzs)
nizk = fiat_shamir.prove_device(srs, das[0], dcs[0], [5, 6, 7, 8])
assert nizk == fiat_shamir.prove(host_srs, pairs[0][1], pairs[0][0], [5, 6, 7, 8])
assert fiat_shamir.verify(host_srs, pairs[0][0], nizk)

full = SRS.new(4, x=7, alpha=11, h_mode="full", device="cpu")
assert full.to_host() == gp.SRS.new(4, x=7, alpha=11)
with tempfile.TemporaryDirectory() as tmp:
    serial.save_srs(os.path.join(tmp, "srs.npz"), full)
    assert serial.load_srs(os.path.join(tmp, "srs.npz"), device="cpu").to_host() == full.to_host()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sonic_tpu"))
assert not bad, bad
print("NO_JAX_OK")
"""

# Run from a file: the spawned ranks import it to find `ranked`.
_NO_JAX_MESH_SCRIPT = r"""
import os, random, sys, tempfile
import torch.multiprocessing as mp
from sonic_tpu_torch import example, golden_protocol as gp, protocol, serial
from sonic_tpu_torch.circuit import random_circuit
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.parallel import distributed, mesh, ntt_sharded
from sonic_tpu_torch.srs import SRS
from sonic_tpu_torch.utils import log, sanitize, trace


def ranked(rank, world, store, host_srs, circuit, assignment, rnd, want):
    # every rank's sharded proof is the single-rank one
    distributed.initialize(backend="gloo", init_method="file://" + store, world_size=world, rank=rank)
    srs = SRS.from_host(host_srs, device="cpu")
    dc = DeviceCircuit.from_host(circuit, device="cpu")
    proof, oracle = protocol.prove(srs, DeviceAssignment.from_host(assignment, device="cpu"), dc, rnd,
                                   mesh=distributed.global_mesh())
    assert serial.proof_to_bytes(proof) == want
    assert protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)
    # the example CLI proves with the mesh of the running world
    assert example.main(["--device", "cpu", "--n", "1", "--q", "1", "--seed", "3"]) == 0


def main():
    rng = random.Random(5)
    circuit, assignment = random_circuit(rng, n=1, q=1)
    rnd = gp.Randomness.generate(rng, m=1)
    host_srs = gp.SRS.new(16, x=rng.randrange(2, gp.P), alpha=rng.randrange(2, gp.P))
    want, _ = protocol.prove(SRS.from_host(host_srs, device="cpu"),
                             DeviceAssignment.from_host(assignment, device="cpu"),
                             DeviceCircuit.from_host(circuit, device="cpu"), rnd)
    with tempfile.TemporaryDirectory() as tmp:
        args = (host_srs, circuit, assignment, rnd, serial.proof_to_bytes(want))
        mp.start_processes(ranked, args=(2, os.path.join(tmp, "store")) + args, nprocs=2,
                           start_method="spawn")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sonic_tpu"))
    assert not bad, bad
    print("NO_JAX_OK")


if __name__ == "__main__":
    main()
"""


def _run_jax_free(args):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_port_proves_and_verifies_without_jax():
    out = _run_jax_free(["-c", _NO_JAX_SCRIPT])
    assert "Success: True" in out and "NO_JAX_OK" in out


def test_sharded_port_proves_without_jax(tmp_path):
    script = tmp_path / "no_jax_mesh.py"
    script.write_text(_NO_JAX_MESH_SCRIPT)
    out = _run_jax_free([str(script)])
    assert out.count("Success: True") == 2 and "NO_JAX_OK" in out


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
               "pairing/host.py", "native.py", "utils/log.py"]


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


# path -> (definitions the copy must hold, definitions it rewrites for torch)
SUBSET_COPIES = {
    "serial.py": (
        ("fr_to_bytes", "fr_from_bytes", "g1_to_bytes", "g1_from_bytes", "g2_to_bytes",
         "_fq2_sqrt", "g2_from_bytes", "proof_to_bytes", "proof_from_bytes"),
        ("save_srs", "load_srs"),
    ),
    "fiat_shamir.py": (
        ("Transcript", "_absorb_circuit", "NizkProof", "prove", "verify"),
        ("prove_device", "_device_circuit_to_host"),
    ),
}


def _assert_subset_copy(path):
    osrc, otree = _module(os.path.join("sonic_tpu", path))
    csrc, ctree = _module(os.path.join("sonic_tpu_torch", path))

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
    kept, rewritten = SUBSET_COPIES[path]
    assert set(kept) <= set(copy) and set(rewritten) <= set(copy) & set(orig)
    for name, seg in copy.items():
        if name not in rewritten:
            assert orig.get(name) == seg, name


def test_serial_copy_is_a_subset_of_the_original():
    _assert_subset_copy("serial.py")


def test_fiat_shamir_copy_is_a_subset_of_the_original():
    _assert_subset_copy("fiat_shamir.py")
