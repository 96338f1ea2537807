"""Multi-process runtime: torch.distributed bring-up and device meshes.

Port of `sonic_tpu/parallel/distributed.py`. The port runs PyTorch's SPMD
idiom: one process per rank, every rank calls the same entry point with
the same inputs and gets the same result. Every sharded entry point
(`prove(mesh=...)`, `prove_batch(mesh=...)`, `msm_sharded`, `ntt_sharded`,
`SRS.new(mesh=...)`) takes an explicit 1-D `DeviceMesh` whose dimension is
named "shard"; this module only standardises process bring-up and mesh
construction.

    torchrun --nproc_per_node=K script.py      # K ranks, one card each

and in the script `initialize()` then `global_mesh()`. The backend is the
caller's choice: NCCL with a card per rank (the default on CUDA), gloo on
the CPU (the default there) and gloo when ranks share one card, since NCCL
refuses two ranks on one GPU ("Duplicate GPU detected").
"""
from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .mesh import make_mesh

# how long a collective waits for the slowest rank before the group fails:
# multichip's rank 0 runs the single-card call while the others wait in a
# broadcast, a prove and a setup of minutes each at n = 2^20, past the
# default 10 minutes
TIMEOUT = datetime.timedelta(minutes=40)


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> None:
    """Bring up the default process group (idempotent; a no-op in a single
    process).

    Arguments default from torchrun's environment: WORLD_SIZE and RANK,
    and init_method "env://", which reads MASTER_ADDR and MASTER_PORT (and
    joins torchrun's own store). backend: NCCL on CUDA, gloo on the CPU
    unless given. On a machine with a card the rank's device becomes
    LOCAL_RANK; NCCL takes one card a rank, so it refuses more ranks on
    this node (LOCAL_WORLD_SIZE, else the world size) than it has cards,
    while gloo ranks share them (LOCAL_RANK modulo the card count). A
    collective waits up to TIMEOUT for the slowest rank."""
    if dist.is_initialized():
        return
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and world_size in (None, 1):
        return  # single process: nothing to do
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        cards, local = torch.cuda.device_count(), _env_int("LOCAL_RANK") or 0
        ranks_here = max(_env_int("LOCAL_WORLD_SIZE") or world_size or 1, local + 1)
        if backend == "nccl" and ranks_here > cards:
            raise RuntimeError(f"initialize: {ranks_here} NCCL ranks on a node with {cards} card(s); "
                               "NCCL takes one card a rank")
        torch.cuda.set_device(local % cards)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=TIMEOUT)


@contextlib.contextmanager
def launched_mesh():
    """For a program's main: `initialize()`, then yield the mesh of all
    ranks when there are several (under torchrun, or a group already up),
    else None. A group this call brought up is torn down on exit."""
    started = not dist.is_initialized()
    initialize()
    if not dist.is_initialized():
        yield None
        return
    try:
        yield global_mesh()
    finally:
        if started:
            dist.destroy_process_group()


def global_mesh() -> DeviceMesh:
    """1-D mesh ("shard") over every rank of the default group."""
    return make_mesh()


def host_slice_mesh() -> DeviceMesh:
    """2-D ("dcn", "ici") mesh of (nodes, ranks per node): shard cross-node
    work on "dcn" and intra-node work on "ici", so heavy collectives stay
    inside a node. Ranks per node: LOCAL_WORLD_SIZE (set by torchrun),
    else all ranks are one node."""
    world = dist.get_world_size()
    per = _env_int("LOCAL_WORLD_SIZE") or world
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (world // per, per), mesh_dim_names=("dcn", "ici"))


def local_mesh() -> DeviceMesh:
    """1-D mesh over this node's ranks (the "ici" row of host_slice_mesh);
    every rank of the world must call it, since it makes process groups."""
    return host_slice_mesh()["ici"]
