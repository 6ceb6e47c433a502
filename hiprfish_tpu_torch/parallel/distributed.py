"""Several processes, one card each (the port of
hiprfish_tpu/parallel/distributed.py).

The reference's only scale-out axis is Snakemake launching one OS process
per FOV (ecoli/Snakefile:63-114). The JAX package has one process per host
over all its chips; the port has one process per card, so a host with N
cards runs N ranks (``torchrun --nproc_per_node=N``), and:

  * across ranks, FOVs are embarrassingly parallel on the inference path:
    the sample list is sharded by rank (``host_shard``), each rank runs the
    batch runner on its own card (``local_mesh``) and writes its artifacts
    to the shared filesystem; no collective crosses ranks there;
  * the ('fov', 'tile') mesh over all ranks (``global_mesh``) carries the
    sharded steps of parallel/fov_batch.py, parallel/spatial.py and the 3D
    pass, and the data-parallel check-head training.

``initialize_from_env`` reads the repo's contract, HIPRFISH_COORDINATOR
(host:port, or an init URL such as tcp://host:port or file:///path),
HIPRFISH_NUM_PROCESSES and HIPRFISH_PROCESS_ID, or torchrun's RANK,
WORLD_SIZE and MASTER_ADDR (with MASTER_PORT, LOCAL_RANK and
LOCAL_WORLD_SIZE). A rank's card is cuda:<local rank>, the local rank
being LOCAL_RANK where a launcher sets it and the process id otherwise
(the HIPRFISH_* contract names no host, so its processes are taken to
share one). NCCL connects the ranks when each has a card of its own; gloo
otherwise, for ranks that share a card or run without one.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from hiprfish_tpu_torch.parallel import mesh as meshlib


def initialize_from_env(timeout: timedelta = meshlib.TIMEOUT) -> bool:
    """Initialise torch.distributed from the environment. Returns True
    when a multi-process runtime is (or already was) initialised, False
    when neither contract is set.

    With CUDA present the process's current device becomes
    cuda:<local rank> (modulo the cards there are) before anything is
    allocated; the NCCL group is bound to it (``device_id``). Every
    process group gets ``timeout``."""
    if dist.is_initialized():
        return True
    env = os.environ
    coord = env.get("HIPRFISH_COORDINATOR")
    if coord:
        url = coord if "://" in coord else f"tcp://{coord}"
        world = int(env["HIPRFISH_NUM_PROCESSES"])
        rank = int(env["HIPRFISH_PROCESS_ID"])
    elif env.get("MASTER_ADDR") and "RANK" in env and "WORLD_SIZE" in env:
        url = "env://"
        world = int(env["WORLD_SIZE"])
        rank = int(env["RANK"])
    else:
        return False
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    kw = {}
    backend = "gloo"
    if torch.cuda.is_available():
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        if local_world <= cards:
            backend = "nccl"
            kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank, timeout=timeout, **kw)
    return True


def host_shard(samples) -> list:
    """This rank's share of the global FOV list, round-robin by rank (all
    of it without an initialised world)."""
    if not dist.is_initialized():
        return list(samples)
    return list(samples)[dist.get_rank()::dist.get_world_size()]


def global_mesh(fov: int | None = None, tile: int = 1,
                device_type: str = "cuda") -> meshlib.DeviceMesh:
    """('fov', 'tile') mesh over every rank of the world (one card each)."""
    return meshlib.make_mesh(fov=fov, tile=tile, device_type=device_type)


def local_mesh(tile: int = 1, device_type: str = "cuda",
               timeout: timedelta = meshlib.TIMEOUT) -> meshlib.DeviceMesh:
    """The (1, 1) mesh of this rank's own card: the inference path's mesh,
    where the parallelism across ranks is the sample-list shard, not a
    collective. A process has one card, so ``tile`` must be 1. Every rank
    of the world calls it (its groups are created collectively)."""
    if tile != 1:
        raise ValueError(f"local_mesh: one card per process, tile {tile}")
    singles = [[r] for r in range(meshlib.require_world())]
    return meshlib.mesh_from_lines(torch.tensor([[dist.get_rank()]]),
                                   singles, singles, device_type, timeout)


def run_distributed_pipeline(samples, clf, cfg=None, max_cells: int = 4096,
                             out_dir: str = ".", tile: int = 1,
                             denoise: bool = True,
                             device=torch.device("cuda")):
    """Multi-process batch runner: initialise the runtime (if configured),
    take this rank's shard of the sample list and run the batch runner on
    this rank's card (``device``: its card unless the caller names the
    CPU). Artifacts go to the shared ``out_dir`` under the reference's
    filename contract; every rank returns its own {sample: (n_cells,
    codes)} map. Without a runtime the one process runs everything on
    one card."""
    from hiprfish_tpu_torch.parallel import fov_batch

    device = torch.device(device)
    mesh = (local_mesh(tile, device.type) if initialize_from_env()
            else None)
    local = host_shard(samples)
    if not local:
        return {}
    return fov_batch.run_batch_pipeline(
        local, clf, cfg=cfg, max_cells=max_cells, mesh=mesh, device=device,
        denoise=denoise, out_dir=out_dir)
