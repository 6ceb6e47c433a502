"""The ('fov', 'tile') device mesh over a torch.distributed world (the port
of hiprfish_tpu/parallel/mesh.py) and the collectives of the scale-out.

JAX runs one controller process over a ``Mesh`` of devices; the port runs
one process per card (or several processes sharing one, over gloo). A mesh
is a ``DeviceMesh`` over the ranks of the initialised world with
``mesh_dim_names=("fov", "tile")``: rank r sits at (r // tile, r % tile),
so the ranks of one 'fov' group (one column) are in fov order and those of
one 'tile' group (one row) in tile order. The mesh's device type says
where each rank works: ``torch.device(mesh.device_type)``, which on
"cuda" is the rank's own card (``torch.cuda.set_device`` was called for
it; see parallel/distributed.py).

The process groups are made here, every one with ``timeout``, so that a
rank that never joins a collective makes the others fail instead of
waiting forever.

Gloo takes CUDA tensors for all-reduce and all-gather, of float, int32
and bool (on the H100 machine, torch 2.11: only its send and receive
refuse them), and NCCL takes them all, so the helpers hand their tensors
to either backend as they are.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the process-group timeout of the port's groups unless the caller gives
# one (NCCL's own default)
TIMEOUT = timedelta(minutes=10)


def mesh_from_lines(grid, fov_lines, tile_lines, device_type: str,
                    timeout: timedelta) -> DeviceMesh:
    """A DeviceMesh over ``grid`` from new groups, one per line of each
    dim. new_group is collective: every rank creates every group, in the
    same order, and keeps the ones it belongs to."""
    rank = dist.get_rank()
    own = []
    for lines in (fov_lines, tile_lines):
        mine = None
        for line in lines:
            group = dist.new_group(line, timeout=timeout)
            if rank in line:
                mine = group
        own.append(mine)
    return DeviceMesh.from_group(own, device_type, mesh=grid,
                                 mesh_dim_names=("fov", "tile"))


def require_world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed first (parallel/"
                           "distributed.initialize_from_env)")
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None, fov: int | None = None,
              tile: int = 1, device_type: str = "cuda",
              timeout: timedelta = TIMEOUT) -> DeviceMesh:
    """('fov', 'tile') mesh over every rank of the initialised world.

    fov: data parallelism over fields of view; tile: spatial sharding
    within a FOV or volume (halo exchange). ``fov`` defaults to
    n_devices // tile, ``n_devices`` to the world size; fov * tile must
    equal the world size (one rank per mesh slot). ``device_type``: where
    each rank works, its card unless the caller names the CPU."""
    world = require_world()
    n = world if n_devices is None else n_devices
    if fov is None:
        fov = n // tile
    if fov < 1 or tile < 1 or fov * tile != world:
        raise ValueError(f"make_mesh: fov {fov} x tile {tile} must equal "
                         f"the world size {world}")
    grid = torch.arange(world).reshape(fov, tile)
    return mesh_from_lines(grid, grid.T.tolist(), grid.tolist(), device_type,
                           timeout)


def dim_size(mesh: DeviceMesh, dim: str) -> int:
    """The number of ranks along the mesh dim ``dim``."""
    return mesh.size(mesh.mesh_dim_names.index(dim))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """Where this rank works: its card (the current CUDA device) or the
    CPU."""
    return torch.device(mesh.device_type)


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh,
                    dim: str = "fov") -> torch.Tensor:
    """Every rank's equal-shaped ``t`` of the mesh dim ``dim``,
    concatenated along axis 0 in the dim's order (the gather of a
    ``P(dim)`` block-sharded array)."""
    group = mesh.get_group(dim)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, dims=("fov",),
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the mesh dims ``dims``, one after the
    other (SUM over both dims is the sum over the mesh, MAX its maximum).
    Returns ``t``."""
    for dim in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(dim))
    return t


def all_gather_object(obj, mesh: DeviceMesh, dim: str = "fov") -> list:
    """Every rank's picklable ``obj`` of the mesh dim ``dim``, in the
    dim's order."""
    group = mesh.get_group(dim)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
