"""Device mesh, the collectives and the sharded MSM.

Port of `sonic_tpu/parallel/mesh.py` onto torch.distributed. A mesh is a
1-D `torch.distributed.device_mesh.DeviceMesh` whose dimension is named
"shard"; its collectives run on `mesh.get_group()` and a rank's index is
`mesh.get_local_rank()`. Every rank holds the same inputs (SPMD), takes
its contiguous share of the rows (`row_span`, `shard_rows`) and gets the
same result back (`all_gather_rows`, `sum_over_ranks`).

Limbs travel as they are, int64 tensors; points travel as their
coordinate tensors stacked into one. `all_gather` needs equal shapes on
every rank, so callers that gather rows pad them to a multiple of the
world size (`shard_rows`).

The sharded MSM splits the point axis: rank r runs the MSM over its slice
of the points and of every MSM's scalars, with its own plan and kernel-2
launch, and the ranks' window totals (W points per MSM) are gathered and
added in rank order. The MSM is linear, so that is the whole MSM's
window totals: the reference gathers (lanes, W, B) bucket grids instead,
because GSPMD partitions its lane axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..curve.group import GroupOps, Jacobian, g1
from ..msm import pippenger


def make_mesh(n: int | None = None) -> DeviceMesh:
    """1-D mesh ("shard") over ranks 0 .. n-1 of the default group (all of
    them when n is None); the default group must be up."""
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, list(range(n or dist.get_world_size())),
                      mesh_dim_names=("shard",))


def row_span(n: int, mesh: DeviceMesh) -> tuple[int, int]:
    """[lo, hi): this rank's contiguous share of n rows, ceil(n / world)
    rows a rank; the last ranks' shares may be short or empty."""
    per = -(-n // mesh.size())
    lo = min(n, mesh.get_local_rank() * per)
    return lo, min(n, lo + per)


def shard_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of t's leading axis after zero rows pad it to a
    multiple of the world size, so every rank's slice has the same shape."""
    per = -(-t.shape[0] // mesh.size())
    pad = per * mesh.size() - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])], 0)
    r = mesh.get_local_rank()
    return t[r * per : (r + 1) * per]


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's t (equal shapes) concatenated along the leading axis
    in rank order; the same tensor on every rank."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(out, t, group=mesh.get_group())
    return torch.cat(out, 0)


def all_to_all_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The leading axis of t cut into world-size equal chunks, chunk s sent
    to rank s; returns the chunks received, in rank order along the
    leading axis."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.get_group())
    return out


def sum_over_ranks(part: pippenger.WindowTotals, mesh: DeviceMesh) -> pippenger.WindowTotals:
    """Each rank's window totals (..., W) gathered and added with the
    group's addition in rank order 0 .. R-1, so every rank holds the same
    projective values."""
    tot = part.totals
    ranks = all_gather_rows(torch.stack(list(tot)).unsqueeze(0), mesh)
    acc = Jacobian(*ranks[0])
    for r in range(1, ranks.shape[0]):
        acc = part.group.add(acc, Jacobian(*ranks[r]))
    return pippenger.WindowTotals(acc, part.c, part.group)


@pippenger.group_first_too
def msm_sharded(points, scalars_std: torch.Tensor, mesh: DeviceMesh, c: int | None = None,
                group: GroupOps = g1) -> Jacobian:
    """Sum_i scalars[i] * points[i] over `group` (G1 by default) with the
    point axis sharded over the mesh (scalars (N, 16), or (M, N, 16) for M
    MSMs sharing the points); the same Jacobian on every rank. The
    reference's order, msm_sharded(group, points, scalars_std, mesh, c),
    runs too."""
    return pippenger.msm(points, scalars_std, c, mesh=mesh, group=group)
