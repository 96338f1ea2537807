"""sonic_tpu_torch — the Sonic zk-SNARK prover and verifier in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of `sonic_tpu` (JAX/Pallas on TPU), which stays in the repository as
the reference. The module layout mirrors it, so each module's counterpart
has the same name. The package imports torch, numpy and the standard
library, never jax and never sonic_tpu.

Public API (the reference's main path):

    SRS.from_host(host_srs, device=) / SRS.new(d, x, alpha, h_mode="verifier", ...)
    DeviceCircuit.from_host(circuit, device=), DeviceAssignment.from_host(a, device=)
    prove(srs, assignment, circuit, rnd) -> (Proof, RndOracle)
    verify(srs, circuit, proof, y, z, yzs) -> bool

Submodules are imported lazily, so `import sonic_tpu_torch.golden` and
friends stay cheap.
"""

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
    "verify",
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
    "verify": "protocol",
    "SRS": "srs",
}


def __getattr__(name):
    if name in _WHERE:
        import importlib

        return getattr(importlib.import_module(f".{_WHERE[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
