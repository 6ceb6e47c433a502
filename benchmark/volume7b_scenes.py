"""Seeded synthetic stitched biofilm volumes, rendered on the device: the
source of work of the 3D configurations (``"scenes": "volume7b_scenes"``).

A volume is a jittered 3D grid of ellipsoidal cells, never touching, each
with its barcode's unit-peak spectrum times a profile that falls from its
gain at the centre to 0.8 of it at the rim, plus uniform noise (a frozen
copy of the model of ``hiprfish_tpu_torch.utils.synthetic3d``, with its
per-node integer hash, so any z-slab of it is rendered in O(voxels)). The
microscope saw it as a grid of overlapping tiles of the channel sum, each
tile's window moved by its own small random shift (the first tile's not),
cut from the edge-padded volume (a frozen copy of
``chip_smoke._volume_tiles``). The channel data of the same cells, with
noise of its own, comes as channels-major z-slabs.

From ``(seed, index)`` alone come the hash's salt (the geometry, gains and
barcodes), the tile shifts and both noise streams: the same pair gives the
same volume, and every index a new one. The one departure from the port's
model: an axis shorter than its grid pitch keeps one node (the CPU size's
40 planes against a z pitch of 52).

This module imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from scenes import barcode_spectra

_M32 = 0xFFFFFFFF


def _hash_u32(ix, iy, iz, salt: int):
    """The per-node uint32 hash on int64 tensors (each product masked to
    its low 32 bits)."""
    h = ((ix * 0x9E3779B9) & _M32) ^ ((iy * 0x85EBCA6B) & _M32) \
        ^ ((iz * 0xC2B2AE35) & _M32) ^ (salt & _M32)
    h = ((h ^ (h >> 16)) * 0x7FEB352D) & _M32
    h = ((h ^ (h >> 15)) * 0x846CA68B) & _M32
    return h ^ (h >> 16)


def _uniform(shape, seed: int, stream: int, device) -> torch.Tensor:
    """U[0, 1) f32 noise of one slab from its own torch.Generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + stream)
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


class Volume:
    """The cells of one volume: ``truth_chunk`` of any z-slab, and the
    channel sum and channels-major spectra rendered from it."""

    def __init__(self, traffic: dict, shape, salt: int, n_codes: int):
        self.t, self.shape, self.salt = traffic, tuple(shape), salt
        self.n_codes = n_codes
        self.grid = tuple(max(1, s // p)
                          for s, p in zip(self.shape, traffic["spacing"]))

    @property
    def n_cells(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def node_codes(self) -> np.ndarray:
        """(n_cells,) barcode index (0-based) per node, row-major."""
        ix, iy, iz = torch.meshgrid(*(torch.arange(g) for g in self.grid),
                                    indexing="ij")
        return (_hash_u32(ix, iy, iz, self.salt + 7) % self.n_codes) \
            .reshape(-1).numpy()

    def truth_chunk(self, z0: int, zc: int, device):
        """(labels (X, Y, zc) int32 with 1-based node ids, code index
        int32, profile f32) of planes [z0, z0 + zc)."""
        t = self.t
        x, y, _ = self.shape
        sx, sy, sz = t["spacing"]
        gx, gy, gz = self.grid
        f32 = torch.float32
        nx, ny, nz = torch.meshgrid(
            torch.arange(gx, device=device), torch.arange(gy, device=device),
            torch.arange(gz, device=device), indexing="ij")

        def u(k):
            return _hash_u32(nx, ny, nz, self.salt + k).to(f32) / 2.0 ** 32

        jit = t["jitter_px"]
        (lo_a, lo_b, lo_c), (hi_a, hi_b, hi_c) = (t["semi_axes_lo"],
                                                  t["semi_axes_hi"])
        g_lo, g_hi = t["brightness"]
        cx = (nx.to(f32) + 0.5) * sx + (u(1) - 0.5) * 2 * jit
        cy = (ny.to(f32) + 0.5) * sy + (u(2) - 0.5) * 2 * jit
        cz = (nz.to(f32) + 0.5) * sz + (u(3) - 0.5) * 2 * jit
        a = lo_a + u(4) * (hi_a - lo_a)
        b = lo_b + u(5) * (hi_b - lo_b)
        c = lo_c + u(6) * (hi_c - lo_c)
        theta = u(7) * float(np.float32(np.pi))
        ct, st = torch.cos(theta), torch.sin(theta)
        code = (_hash_u32(nx, ny, nz, self.salt + 7) % self.n_codes) \
            .to(torch.int32)
        gain = g_lo + u(8) * (g_hi - g_lo)

        xs = torch.arange(x, device=device)
        ys = torch.arange(y, device=device)
        zs = torch.arange(zc, device=device) + z0
        ix = torch.clamp(xs // sx, 0, gx - 1)[:, None, None]
        iy = torch.clamp(ys // sy, 0, gy - 1)[None, :, None]
        iz = torch.clamp(zs // sz, 0, gz - 1)[None, None, :]

        def at(tbl):
            return tbl[ix, iy, iz]

        dx = xs.to(f32)[:, None, None] - at(cx)
        dy = ys.to(f32)[None, :, None] - at(cy)
        dz = zs.to(f32)[None, None, :] - at(cz)
        ctv, stv = at(ct), at(st)
        uu = dx * ctv + dy * stv
        vv = -dx * stv + dy * ctv
        ua, vb, wc = uu / at(a), vv / at(b), dz / at(c)
        r2 = ua * ua + vb * vb + wc * wc
        inside = r2 <= 1.0
        node_id = (ix * gy + iy) * gz + iz
        labels = torch.where(inside, node_id + 1, 0).to(torch.int32)
        profile = torch.where(
            inside, (1.0 - 0.2 * torch.sqrt(torch.clamp(r2, 0.0, 1.0)))
            * at(gain), 0.0)
        return labels, at(code).expand(labels.shape), profile.to(f32)

    def sum_volume(self, sum_lut: torch.Tensor, seed: int,
                   z_chunk: int = 16) -> torch.Tensor:
        """The (X, Y, Z) channel sum, slab by slab: profile x the summed
        spectrum of the cell's barcode + noise of amplitude ``noise``."""
        dev = sum_lut.device
        z = self.shape[2]
        out = []
        for z0 in range(0, z, z_chunk):
            _, code, prof = self.truth_chunk(z0, min(z_chunk, z - z0), dev)
            base = prof * sum_lut[code.to(torch.int64)]
            out.append(base + _uniform(base.shape, seed, z0, dev)
                       * self.t["noise"])
        return torch.cat(out, dim=2)

    def channel_slab(self, z0: int, zc: int, lut: torch.Tensor, seed: int,
                     dtype) -> torch.Tensor:
        """(C, zc, X, Y) channels-major slab of planes [z0, z0 + zc):
        profile x barcode spectrum + noise, stored as ``dtype``, contiguous
        as a reader of the stack's files would hand it over."""
        _, code, prof = self.truth_chunk(z0, zc, lut.device)
        code_t = code.permute(2, 0, 1).to(torch.int64)
        base = lut.T[:, code_t] * prof.permute(2, 0, 1)[None]
        noise = _uniform(base.shape, seed, z0 + 100003, lut.device)
        return (base + noise * self.t["noise"]).to(dtype).contiguous()


def cut_tiles(vol: torch.Tensor, grid, overlap: int, shifts, pad: int):
    """The (ty, tx, Z) tiles of an (X, Y, Z) volume in row-major ``grid``
    order, ``overlap`` planes shared between neighbours, each window moved
    by its (dy, dx, dz) shift and cut from the volume edge-padded by
    ``pad`` >= the largest shift."""
    x, y, z = vol.shape
    gy, gx = grid
    ty = (x + (gy - 1) * overlap) // gy
    tx = (y + (gx - 1) * overlap) // gx
    if gy * ty - (gy - 1) * overlap != x or gx * tx - (gx - 1) * overlap != y:
        raise ValueError(f"a {grid} grid with {overlap} px of overlap does "
                         f"not tile {x} x {y}")
    volp = F.pad(vol[None, None], (pad,) * 6, mode="replicate")[0, 0]
    tiles = []
    for i in range(gy):
        for j in range(gx):
            dy, dx, dz = shifts[i * gx + j]
            y0 = i * (ty - overlap) + pad - dy
            x0 = j * (tx - overlap) + pad - dx
            tiles.append(volp[y0:y0 + ty, x0:x0 + tx,
                              pad - dz:pad - dz + z].clone())
    return tiles


class VolumeStack:
    """One volume as the program and the reference take it: ``tiles``
    (the summed tiles in row-major ``grid`` order, ``overlap`` planes
    shared), ``slab_planes`` and ``slabs(z0, zc)``, the (C, zc, X, Y)
    channel data of planes [z0, z0 + zc) rendered when asked for."""

    def __init__(self, tiles, grid, overlap, slab_planes, slabs, shape):
        self.tiles, self.grid, self.overlap = tiles, tuple(grid), overlap
        self.slab_planes, self.slabs = slab_planes, slabs
        self.shape = tuple(shape)

    def take_tiles(self) -> list:
        """The tiles, handed over: the stack lets go of them."""
        tiles, self.tiles = self.tiles, None
        return tiles


class Scenes:
    """The volumes of one traffic at one size, drawn from ``seed``."""

    def __init__(self, traffic: dict, layout: dict, shape, seed: int):
        self.traffic, self.shape, self.seed = traffic, tuple(shape), seed
        self.lut = barcode_spectra(layout)[1:].astype(np.float32)
        self.n_codes = self.lut.shape[0]

    def plan(self, index: int) -> dict:
        """The hash salt, the tile shifts (the first tile's zero) and the
        two noise seeds of volume ``index``."""
        t = self.traffic
        ss = np.random.SeedSequence([int(self.seed), int(index)])
        salt, sum_seed, slab_seed = (int(v) for v in
                                     ss.generate_state(3, np.uint32))
        rng = np.random.default_rng(ss.spawn(1)[0])
        gy, gx = t["tile_grid"]
        m = t["tile_shift_max"]
        shifts = rng.integers(-m, m + 1, (gy * gx, 3))
        shifts[0] = 0
        return {"salt": salt, "sum_seed": sum_seed, "slab_seed": slab_seed,
                "tile_shifts": [tuple(int(v) for v in s) for s in shifts]}

    def make(self, index: int, device):
        """(stack, truth, plan) of volume ``index`` on ``device``: a
        VolumeStack; the planted cells' count and barcodes (1..127 per
        node); the plan."""
        t = self.traffic
        p = self.plan(index)
        vol = Volume(t, self.shape, p["salt"], self.n_codes)
        lut = torch.from_numpy(self.lut).to(device)
        tiles = cut_tiles(vol.sum_volume(lut.sum(dim=1), p["sum_seed"]),
                          t["tile_grid"], t["overlap"], p["tile_shifts"],
                          t["tile_shift_max"])
        dtype = getattr(torch, t["slab_dtype"])

        def slabs(z0, zc):
            return vol.channel_slab(z0, zc, lut, p["slab_seed"], dtype)

        stack = VolumeStack(tiles, t["tile_grid"], t["overlap"],
                            t["slab_planes"], slabs, self.shape)
        truth = {"n_cells": vol.n_cells, "codes": vol.node_codes() + 1}
        return stack, truth, p
