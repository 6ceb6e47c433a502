"""LP-CV over row shards with halo exchange (the port of
hiprfish_tpu/parallel/spatial.py).

The LP-CV stencil needs a (patch_size - 1) // 2 halo. With a FOV's rows
split over the mesh's 'tile' ranks, each rank takes its neighbours'
boundary strips, runs kernel B2 (ops/line_profile.lp_cv_enhance_2d; the
JAX function runs XLA there) on its halo'd block and keeps its own rows.
LP-CV is per pixel, so every kept row reads only rows inside the block,
and the result is bitwise the unsharded B2's: the outer image edge is
edge-padded by B2 itself, and an edge shard's missing neighbour is its own
edge row repeated, which is what that padding gives. The reference's
halo'd CPU tiling (200x200+10, biofilm_analysis.py:900-917) is the same
decomposition.

The strips are exchanged by one all-gather of every rank's top and bottom
strip (2 halo rows each): the same collective on NCCL and on gloo, which
has no CUDA send/receive.
"""

from __future__ import annotations

import torch

from hiprfish_tpu_torch.ops import line_profile as lp
from hiprfish_tpu_torch.parallel import mesh as meshlib


def _exchange_row_halos(block: torch.Tensor, halo: int, mesh,
                        axis_name: str) -> torch.Tensor:
    """``block`` with ``halo`` rows of the previous and the next shard
    along ``axis_name`` above and below it: (rows + 2 halo, cols). Edge
    shards repeat their own edge rows."""
    n = meshlib.dim_size(mesh, axis_name)
    idx = mesh.get_local_rank(axis_name)
    strips = meshlib.all_gather_rows(
        torch.cat([block[:halo], block[-halo:]])[None], mesh, axis_name)
    top = (block[:1].expand(halo, -1) if idx == 0
           else strips[idx - 1, halo:])
    bottom = (block[-1:].expand(halo, -1) if idx == n - 1
              else strips[idx + 1, :halo])
    return torch.cat([top, block, bottom])


def lp_cv_enhance_2d_sharded(image, mesh, axis_name: str = "tile",
                             patch_size: int = 11,
                             phi_range: int = 9) -> torch.Tensor:
    """LP-CV enhancement of an (H, W) image whose rows are block-sharded
    over the mesh dim ``axis_name``: each rank moves its own rows to its
    device, exchanges halos, runs B2 and keeps its rows; the full (H, W)
    f32 result is gathered on every rank. H must divide by the dim's size
    into blocks of at least the halo."""
    halo = (patch_size - 1) // 2
    n = meshlib.dim_size(mesh, axis_name)
    h = image.shape[0]
    if h % n or (halo and h // n < halo):
        raise ValueError(f"lp_cv_enhance_2d_sharded: H={h} must divide by "
                         f"mesh[{axis_name!r}]={n} into blocks of at least "
                         f"{halo} rows")
    rows = h // n
    idx = mesh.get_local_rank(axis_name)
    block = torch.as_tensor(image[idx * rows:(idx + 1) * rows]).to(
        meshlib.mesh_device(mesh), torch.float32)
    padded = (_exchange_row_halos(block, halo, mesh, axis_name) if halo
              else block)
    local = lp.lp_cv_enhance_2d(padded, patch_size, phi_range)
    return meshlib.all_gather_rows(local[halo:halo + rows], mesh, axis_name)
