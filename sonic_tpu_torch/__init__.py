"""sonic_tpu_torch — the Sonic zk-SNARK prover and verifier in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of `sonic_tpu` (JAX/Pallas on TPU), which stays in the repository as
the reference. The module layout mirrors it, so each module's counterpart
has the same name. The package imports torch, numpy and the standard
library, never jax and never sonic_tpu.

Public API (the reference's exports):

    SRS.new(d, x, alpha, h_mode="full", device=) / SRS.from_host(host_srs, device=)
    DeviceCircuit.from_host(circuit, device=), DeviceAssignment.from_host(a, device=)
    DeviceCircuit.from_rows(wL, wR, wO, cs, device=)  (sparse rows: sparse.CsrRows)
    prove(srs, assignment, circuit, rnd) -> (Proof, RndOracle)
    prove_batch(srs, assignments, circuits, rnds) -> [(Proof, RndOracle)]
    verify(srs, circuit, proof, y, z, yzs) -> bool
    hsc_prove / hsc_verify, commit_poly / open_poly / pcv
    fiat_shamir.prove_device, serial.save_srs / load_srs

Several ranks: `prove`, `prove_batch`, `SRS.new`, `hsc_prove` and the
commitment functions take `mesh=`, a 1-D DeviceMesh from
`parallel.distributed.global_mesh()` after `parallel.distributed.initialize()`.

`device=None` is the CUDA card; without one the constructors raise. Pass
`device="cpu"` to run on the CPU.

Submodules are imported lazily, so `import sonic_tpu_torch.golden` and
friends stay cheap.
"""

__version__ = "0.3.0"  # the reference package's version

__all__ = [
    "ArithCircuit",
    "Assignment",
    "GateWeights",
    "DeviceAssignment",
    "DeviceCircuit",
    "Proof",
    "RndOracle",
    "Randomness",
    "HscProof",
    "prove",
    "prove_batch",
    "verify",
    "hsc_prove",
    "hsc_verify",
    "commit_poly",
    "open_poly",
    "pcv",
    "SRS",
]

_WHERE = {
    "ArithCircuit": "circuit",
    "Assignment": "circuit",
    "GateWeights": "circuit",
    "DeviceAssignment": "constraints",
    "DeviceCircuit": "constraints",
    "Proof": "golden_protocol",
    "RndOracle": "golden_protocol",
    "Randomness": "golden_protocol",
    "HscProof": "golden_protocol",
    "prove": "protocol",
    "prove_batch": "protocol",
    "verify": "protocol",
    "hsc_prove": "signature",
    "hsc_verify": "signature",
    "commit_poly": "commitment",
    "open_poly": "commitment",
    "pcv": "commitment",
    "SRS": "srs",
}


def __getattr__(name):
    if name in _WHERE:
        import importlib

        return getattr(importlib.import_module(f".{_WHERE[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
