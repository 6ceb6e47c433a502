"""Frozen copy of the 3D phase correlation of
hiprfish_tpu_torch/ops/register.py (``register_translation_3d``) and the
semantics of its tile stitch (``pipeline/segment3d.stitch_tiles_device``)
for the benchmark's plain reference; it imports nothing of the port."""

from __future__ import annotations

import torch


def register_translation_3d(reference: torch.Tensor,
                            moving: torch.Tensor) -> torch.Tensor:
    """Integer 3D shift aligning ``moving`` to ``reference`` as a (3,)
    float32 tensor: argmax of |ifftn| of the normalized cross-power
    spectrum (first index on ties), wrapped to (-shape/2, shape/2]."""
    f_ref = torch.fft.fftn(reference.to(torch.float32))
    f_mov = torch.fft.fftn(moving.to(torch.float32))
    cross = f_ref * torch.conj(f_mov)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-12)
    cc_abs = torch.abs(torch.fft.ifftn(cross))
    flat = torch.argmax(cc_abs.reshape(-1))
    idx = []
    for s in reversed(reference.shape):
        idx.append(flat % s)
        flat = flat // s
    maxima = torch.stack(idx[::-1]).to(torch.float32)
    shape = torch.tensor(reference.shape, dtype=torch.float32,
                         device=reference.device)
    midpoints = torch.floor(shape / 2)
    return torch.where(maxima > midpoints, maxima - shape, maxima)


def tile_shifts(tiles, grid, overlap: int) -> list:
    """[(dy, dx, dz)] of each tile against its neighbour, in row-major
    grid order: the first tile (0, 0, 0), the first of each row against
    the first of the row above on their overlap faces, every other tile
    against its left neighbour on theirs."""
    gy, gx = grid
    out = []
    for i in range(gy):
        for j in range(gx):
            if i == 0 and j == 0:
                s = torch.zeros(3)
            elif j == 0:
                s = register_translation_3d(tiles[(i - 1) * gx][-overlap:],
                                            tiles[i * gx][:overlap])
            else:
                s = register_translation_3d(
                    tiles[i * gx + j - 1][:, -overlap:],
                    tiles[i * gx + j][:, :overlap])
            out.append(tuple(int(v) for v in s.tolist()))
    return out


def stitch_tiles(tiles, grid, overlap: int, pad: int = 10) -> torch.Tensor:
    """The (X, Y, Z) f32 volume of (ty, tx, tz) tiles in row-major ``grid``
    order with ``overlap`` planes shared between neighbours: each tile
    placed at its nominal origin plus its chained shifts (tile_shifts,
    the row's first along y, then along the row), the tiles added in
    order into a volume with a ``pad`` border and each voxel divided by
    the tiles that cover it (at least 1), the border cropped off."""
    gy, gx = grid
    ty, tx, tz = tiles[0].shape
    shape = (gy * ty - (gy - 1) * overlap, gx * tx - (gx - 1) * overlap, tz)
    sh = tile_shifts(tiles, grid, overlap)
    dev = tiles[0].device
    full = torch.zeros([n + 2 * pad for n in shape], dtype=torch.float32,
                       device=dev)
    count = torch.zeros_like(full)
    for i in range(gy):
        for j in range(gx):
            sy = i * (ty - overlap) + pad + sum(sh[r * gx][0]
                                                for r in range(1, i + 1)) \
                + sum(sh[i * gx + c][0] for c in range(1, j + 1))
            sx = j * (tx - overlap) + pad + sum(sh[i * gx + c][1]
                                                for c in range(j + 1))
            sz = pad + sum(sh[i * gx + c][2] for c in range(j + 1))
            win = (slice(sy, sy + ty), slice(sx, sx + tx), slice(sz, sz + tz))
            full[win] += tiles[i * gx + j].to(torch.float32)
            count[win] += 1.0
    vol = full / torch.clamp(count, min=1.0)
    return vol[pad:pad + shape[0], pad:pad + shape[1],
               pad:pad + shape[2]].contiguous()
