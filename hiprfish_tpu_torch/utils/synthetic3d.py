"""Synthetic 3D biofilm volumes with known per-cell barcodes (torch port of
hiprfish_tpu/utils/synthetic3d.py).

Cells sit on a jittered 3D grid; each grid node's geometry (centre jitter,
semi-axes, rotation, brightness) and barcode come from an integer hash of
the node, so any z-slab of the truth labels, the channel-summed intensity
or the channels-major spectral data is generated on the device of its
inputs in O(voxels), and the 63-channel volume never has to exist whole.
The jitter and semi-axis bounds keep every voxel inside at most the cell
of its own grid node.

The hash is the reference's uint32 arithmetic done in int64 and masked to
32 bits after each multiply, so labels, codes and profiles equal the
reference's (tests hold them equal). The uniform noise comes from a
``torch.Generator`` seeded per slab from ``seed`` and the slab's z0: the
same distribution as the reference's ``jax.random`` noise, other bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class VolumeSpec:
    """Geometry of a synthetic cell volume."""

    shape: tuple          # (X, Y, Z)
    spacing: tuple = (36, 36, 52)   # grid pitch per axis
    jitter: tuple = (4.0, 4.0, 4.0)
    semi_axes_lo: tuple = (11.0, 7.0, 8.0)   # (major-xy, minor-xy, z)
    semi_axes_hi: tuple = (14.0, 9.0, 11.0)
    noise: float = 0.03
    brightness_lo: float = 0.8
    brightness_hi: float = 1.2
    seed: int = 0

    @property
    def grid(self):
        return tuple(s // p for s, p in zip(self.shape, self.spacing))

    @property
    def n_cells(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz


def _hash_u32(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
              salt: int) -> torch.Tensor:
    """The reference's per-node uint32 hash on int64 tensors: each product
    wraps modulo 2^64 (past 2^63 too) and the mask keeps its low 32
    bits, which are the uint32 product's."""
    h = ((ix * 0x9E3779B9) & _M32) ^ ((iy * 0x85EBCA6B) & _M32) \
        ^ ((iz * 0xC2B2AE35) & _M32) ^ (salt & _M32)
    h = ((h ^ (h >> 16)) * 0x7FEB352D) & _M32
    h = ((h ^ (h >> 15)) * 0x846CA68B) & _M32
    return h ^ (h >> 16)


def node_codes(spec: VolumeSpec, n_codes: int) -> np.ndarray:
    """(n_cells,) barcode index per grid node in row-major node order."""
    gx, gy, gz = spec.grid
    ix, iy, iz = torch.meshgrid(torch.arange(gx), torch.arange(gy),
                                torch.arange(gz), indexing="ij")
    return (_hash_u32(ix, iy, iz, spec.seed + 7) % n_codes).reshape(-1) \
        .numpy().astype(np.uint32)


def truth_chunk(spec: VolumeSpec, n_codes: int, z0: int, zc: int,
                device=torch.device("cuda")):
    """(labels (X, Y, zc) int32 with 1-based node ids, code_idx int32,
    profile f32 in [0, 1]) for the z-slab [z0, z0 + zc), on the card
    unless the caller names another device.

    Each node's parameters are computed once on the (gx, gy, gz) grid and
    gathered per voxel: the same f32 operations on the same inputs as the
    reference's per-voxel evaluation."""
    x, y, _ = spec.shape
    sx, sy, sz = spec.spacing
    gx, gy, gz = spec.grid
    f32 = torch.float32
    nx, ny, nz = torch.meshgrid(
        torch.arange(gx, device=device), torch.arange(gy, device=device),
        torch.arange(gz, device=device), indexing="ij")

    def u(salt):
        return _hash_u32(nx, ny, nz, spec.seed + salt).to(f32) / 2.0 ** 32

    lo, hi = spec.semi_axes_lo, spec.semi_axes_hi
    cx = (nx.to(f32) + 0.5) * sx + (u(1) - 0.5) * 2 * spec.jitter[0]
    cy = (ny.to(f32) + 0.5) * sy + (u(2) - 0.5) * 2 * spec.jitter[1]
    cz = (nz.to(f32) + 0.5) * sz + (u(3) - 0.5) * 2 * spec.jitter[2]
    a = lo[0] + u(4) * (hi[0] - lo[0])
    b = lo[1] + u(5) * (hi[1] - lo[1])
    c = lo[2] + u(6) * (hi[2] - lo[2])
    theta = u(7) * float(np.float32(np.pi))
    ct = torch.cos(theta)
    st = torch.sin(theta)
    code = (_hash_u32(nx, ny, nz, spec.seed + 7) % n_codes).to(torch.int32)
    gain = spec.brightness_lo + u(8) * (spec.brightness_hi
                                        - spec.brightness_lo)

    xs = torch.arange(x, device=device)
    ys = torch.arange(y, device=device)
    zs = torch.arange(zc, device=device) + z0
    ix = torch.clamp(xs // sx, 0, gx - 1)[:, None, None]
    iy = torch.clamp(ys // sy, 0, gy - 1)[None, :, None]
    iz = torch.clamp(zs // sz, 0, gz - 1)[None, None, :]

    def at(node_tbl):
        return node_tbl[ix, iy, iz]

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
    code_idx = at(code).expand(labels.shape)
    profile = torch.where(
        inside, (1.0 - 0.2 * torch.sqrt(torch.clamp(r2, 0.0, 1.0)))
        * at(gain), 0.0)
    return labels, code_idx, profile.to(f32)


def _uniform(shape, seed: int, stream: int, device) -> torch.Tensor:
    """U[0, 1) f32 noise of one slab from its own torch.Generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + stream)
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


def sum_chunk(spec: VolumeSpec, n_codes: int, z0: int, zc: int,
              sum_lut: torch.Tensor, seed: int) -> torch.Tensor:
    """Channel-summed (X, Y, zc) intensity slab on the device of
    ``sum_lut``: profile * the summed spectrum of the cell's barcode +
    uniform noise of amplitude spec.noise."""
    dev = sum_lut.device
    _, code_idx, profile = truth_chunk(spec, n_codes, z0, zc, dev)
    base = profile * sum_lut.to(torch.float32)[code_idx.to(torch.int64)]
    return base + _uniform(base.shape, seed, z0, dev) * spec.noise


def channel_chunk_cm(spec: VolumeSpec, n_codes: int, z0: int, zc: int,
                     spectra_lut: torch.Tensor, seed: int,
                     dtype=torch.float32) -> torch.Tensor:
    """(C, zc, X, Y) channels-major spectral slab on the device of
    ``spectra_lut`` ((n_codes, C)): profile x barcode spectrum + noise,
    stored as ``dtype`` (bf16 halves the slab and the measurement's read;
    the per-cell sums accumulate in f32 either way)."""
    dev = spectra_lut.device
    _, code_idx, profile = truth_chunk(spec, n_codes, z0, zc, dev)
    code_t = code_idx.permute(2, 0, 1).to(torch.int64)     # (zc, X, Y)
    prof_t = profile.permute(2, 0, 1)
    lut_t = spectra_lut.to(torch.float32).T                # (C, n_codes)
    base = lut_t[:, code_t] * prof_t[None]
    noise = _uniform(base.shape, seed, z0 + 100003, dev)
    return (base + noise * spec.noise).to(dtype)


def channel_chunk(spec: VolumeSpec, n_codes: int, z0: int, zc: int,
                  spectra_lut: torch.Tensor, seed: int,
                  dtype=torch.float32) -> torch.Tensor:
    """(X, Y, zc, C) voxel-major spectral slab: channel_chunk_cm's values,
    its noise stream included, permuted."""
    return channel_chunk_cm(spec, n_codes, z0, zc, spectra_lut, seed,
                            dtype).permute(2, 3, 1, 0).contiguous()


def build_sum_volume(spec: VolumeSpec, n_codes: int, sum_lut, seed: int = 0,
                     z_chunk: int = 32,
                     device=torch.device("cuda")) -> torch.Tensor:
    """The full (X, Y, Z) channel-summed volume, slab by slab, on the card
    unless the caller names another device."""
    lut = torch.as_tensor(np.asarray(sum_lut, np.float32), device=device)
    z = spec.shape[2]
    return torch.cat([sum_chunk(spec, n_codes, z0, min(z_chunk, z - z0),
                                lut, seed)
                      for z0 in range(0, z, z_chunk)], dim=2)
