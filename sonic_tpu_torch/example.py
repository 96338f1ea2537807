"""End-to-end example program on the PyTorch port.

Port of `sonic_tpu/example.py` (its `--device` path). Reference:
examples/Main.hs:13-74: sample d uniformly in [7n, 100n], random trapdoor
(x, alpha), SRS setup, prove, verify with the prover-returned RndOracle
values, print the result.

Two circuits:
  default        example_circuit_2 with a host (golden) SRS uploaded by
                 SRS.from_host, as the reference example does;
  --n N [--q Q]  random_circuit(rng, n=N, q=Q) with d = 7N + 20 and the
                 verifier-mode SRS.new, whose G1 tables are built on the
                 device (a host SRS at that size takes minutes).

Phase times go to stderr, after a device synchronize.

Usage: python -m sonic_tpu_torch.example [--device cpu|cuda] [--seed N]
                                         [--n N] [--q Q]
"""
from __future__ import annotations

import argparse
import contextlib
import random
import sys
import time

import torch

from . import golden_protocol as gp
from . import protocol
from .circuit import example_circuit_2, random_circuit
from .constraints import DeviceAssignment, DeviceCircuit
from .fields.constants import R_MOD
from .srs import SRS


@contextlib.contextmanager
def _phase(name: str, device: torch.device, **info):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    extra = "".join(f" {k}={v}" for k, v in info.items())
    print(f"{name}: {time.perf_counter() - t0:.3f} s{extra}", file=sys.stderr, flush=True)


def _prove_and_verify(srs, circuit, assignment, rnd, device) -> bool:
    with _phase("upload", device):
        dc = DeviceCircuit.from_host(circuit, device=device)
        da = DeviceAssignment.from_host(assignment, device=device)
    with _phase("prove", device):
        proof, oracle = protocol.prove(srs, da, dc, rnd)
    with _phase("verify", device):
        return protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs)


def sonic_protocol(circuit, assignment, x: int, rng, device) -> bool:
    """examples/Main.hs:13-24: setup -> prove -> verify."""
    n = assignment.n
    d = rng.randrange(7 * n, 100 * n + 1)  # d >= 7n (Protocol.hs:54)
    d = max(d, 16)  # small-n quirk (test/Test/Reference.hs:92-104)
    alpha = rng.randrange(1, R_MOD)
    rnd = gp.Randomness.generate(rng, circuit.weights.q)
    with _phase("setup", device, d=d):
        srs = SRS.from_host(gp.SRS.new(d, x, alpha), device=device)
    return _prove_and_verify(srs, circuit, assignment, rnd, device)


def random_protocol(n: int, q: int, rng, device) -> bool:
    """A random satisfiable circuit of n gates and q linear constraints,
    with the verifier-mode SRS built on the device."""
    circuit, assignment = random_circuit(rng, n=n, q=q)
    d = 7 * n + 20
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    rnd = gp.Randomness.generate(rng, q)
    with _phase("setup", device, d=d):
        srs = SRS.new(d, x, alpha, h_mode="verifier", n_hints=[n], device=device)
    return _prove_and_verify(srs, circuit, assignment, rnd, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cpu", help="torch device: cpu or cuda")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--n", type=int, default=None, help="gates of a random circuit")
    parser.add_argument("--q", type=int, default=None, help="its linear constraints")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("example: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    rng = random.Random(args.seed)
    t0 = time.perf_counter()
    if args.n is None:
        # examples/Main.hs:66-70: random x, z feed the example circuit.
        x = rng.randrange(1, R_MOD)
        z = rng.randrange(1, R_MOD)
        circuit, assignment = example_circuit_2(x, z)
        ok = sonic_protocol(circuit, assignment, x, rng, device)
    else:
        q = args.q if args.q is not None else max(1, args.n // 16)
        ok = random_protocol(args.n, q, rng, device)
    print(f"total: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    print(f"Success: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
