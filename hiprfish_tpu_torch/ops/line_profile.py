"""2D and 3D LP-CV edge enhancement (torch port of
hiprfish_tpu/ops/line_profile.py and of the 3D chunk sweep of
hiprfish_tpu/pipeline/segment3d.py).

``lp_cv_enhance_2d`` is the wrapper of kernel B2 (csrc/lpcv2d.cu), which
takes the line table of any (patch_size, phi_range) as an argument.
``lp_cv_enhance_3d`` is the wrapper of kernel B6 (csrc/lpcv3d.cu), whose
offset table and quartile selection network are a generated header
(kernels/gen_lpcv3d_tables.py): the committed csrc/lpcv3d_tables.cuh for
the default (11, 9, 9), and one written and compiled into the build
directory at the first use of any other configuration. The tables are
built in numpy here for the plain versions: the reference's modules import
jax, so its ``line_table_2d``/``line_table_3d``/``selection_network`` cannot
be imported where jax is absent (tests hold these tables, the kernel's
constants and the header equal to the reference's).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from hiprfish_tpu_torch import kernels


def _line_coords_1axis(interval: int, line_n: int, li: int,
                       increment: int) -> int:
    """Patch coordinate along one axis for sample ``li`` of a line."""
    sign = int(np.sign(interval))
    h = sign * li * (2 * abs(interval) + 1) / line_n
    return int(np.sign(h) * np.floor(abs(h)) + increment - interval)


def line_table_2d(patch_size: int = 11, phi_range: int = 9) -> np.ndarray:
    """(phi_range, patch_size, 2) int patch coordinates of the 2D stencil:
    for orientation phi and sample li, the (row, col) within the patch."""
    increment = (patch_size - 1) // 2
    table = np.zeros((phi_range, patch_size, 2), dtype=np.int64)
    for phi in range(phi_range):
        ivals = np.array([
            int(np.round(increment * np.cos(phi * np.pi / phi_range))),
            int(np.round(increment * np.sin(phi * np.pi / phi_range))),
        ])
        max_interval = ivals[np.argmax(np.abs(ivals))]
        line_n = int(2 * abs(max_interval) + 1)
        if line_n < patch_size:
            diff = (patch_size - line_n) // 2
            for li in range(line_n):
                for a in range(2):
                    table[phi, li + diff, a] = _line_coords_1axis(
                        ivals[a], line_n, li, increment)
            table[phi, :diff] = table[phi, diff]
            table[phi, line_n + diff:] = table[phi, line_n + diff - 1]
        else:
            for li in range(line_n):
                for a in range(2):
                    table[phi, li, a] = _line_coords_1axis(
                        ivals[a], line_n, li, increment)
    return table


# the kernel's copy, computed once per stencil (read only)
_line_table_2d_cached = functools.lru_cache(maxsize=None)(line_table_2d)


def line_table_3d(patch_size: int = 11, theta_range: int = 9,
                  phi_range: int = 9) -> np.ndarray:
    """((theta_range-1)*phi_range, patch_size, 3) int patch coordinates of
    the 3D stencil: for orientation t and sample li, the (x, y, z) within
    the patch."""
    increment = (patch_size - 1) // 2
    n_orient = (theta_range - 1) * phi_range
    table = np.zeros((n_orient, patch_size, 3), dtype=np.int64)
    for theta in range(1, theta_range):
        st = np.sin(theta * np.pi / theta_range)
        for phi in range(phi_range):
            t = (theta - 1) * phi_range + phi
            ivals = np.array([
                int(np.round(increment * np.cos(phi * np.pi / phi_range)
                             * st)),
                int(np.round(increment * np.sin(phi * np.pi / phi_range)
                             * st)),
                int(np.round(increment * np.cos(theta * np.pi
                                                / theta_range))),
            ])
            max_interval = ivals[np.argmax(np.abs(ivals))]
            line_n = int(2 * abs(max_interval) + 1)
            diff = (patch_size - line_n) // 2 if line_n < patch_size else 0
            for li in range(line_n):
                for a in range(3):
                    table[t, li + diff, a] = _line_coords_1axis(
                        ivals[a], line_n, li, increment)
            if diff:
                table[t, :diff] = table[t, diff]
                table[t, line_n + diff:] = table[t, line_n + diff - 1]
    return table


def _batcher_comparators(n: int):
    """Batcher odd-even mergesort comparators (ascending) for n inputs,
    generated for the next power of two with the pairs that touch an index
    >= n dropped (+inf padding makes them no-ops)."""
    p2 = 1
    while p2 < n:
        p2 *= 2
    comps = []
    p = 1
    while p < p2:
        k = p
        while k >= 1:
            for j in range(k % p, p2 - k, 2 * k):
                for i in range(k):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        if i + j + k < n:
                            comps.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return comps


def selection_network(n: int, outputs) -> list:
    """The comparators of the Batcher network that can change the given
    output ranks (a backward prune): applied in order they leave the k-th
    smallest value at index k for every k in ``outputs``."""
    needed = set(outputs)
    kept = []
    for a, b in reversed(_batcher_comparators(n)):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.update((a, b))
    return kept[::-1]


def quartile_ranks(t: int):
    """((lo25, hi25, f25), (lo75, hi75, f75)): the sorted ranks and weights
    of the interpolated 25th/75th percentiles of t values."""
    q25, q75 = 0.25 * (t - 1), 0.75 * (t - 1)
    lo25, hi25 = int(np.floor(q25)), int(np.ceil(q25))
    lo75, hi75 = int(np.floor(q75)), int(np.ceil(q75))
    return (lo25, hi25, q25 - lo25), (lo75, hi75, q75 - lo75)


def _lp_cv_combine(rnc_stack: torch.Tensor,
                   mean: torch.Tensor | None = None) -> torch.Tensor:
    """mean(rnc) * (1 - quartile CV) over the last axis (T orientations);
    ``mean`` is the mean of the orientations, if the caller has it."""
    if mean is None:
        mean = torch.mean(rnc_stack, dim=-1)
    s = torch.sort(rnc_stack, dim=-1).values
    (lo25, hi25, f25), (lo75, hi75, f75) = quartile_ranks(rnc_stack.shape[-1])
    lq = s[..., lo25] * (1 - f25) + s[..., hi25] * f25
    uq = s[..., lo75] * (1 - f75) + s[..., hi75] * f75
    qcv = torch.where(uq > 0, (uq - lq) / (uq + lq + 1e-8),
                      torch.zeros_like(uq))
    return mean * (1.0 - qcv)


def lp_cv_enhance_2d_plain(image: torch.Tensor, patch_size: int = 11,
                           phi_range: int = 9) -> torch.Tensor:
    """Plain-torch LP-CV: edge pad, per-orientation min/max/centre over
    shifted views, normalize, combine. The orientations' mean is their sum
    in order times the float32 reciprocal of phi_range, as the reference's
    CPU program computes it."""
    pad = (patch_size - 1) // 2
    img = image.to(torch.float32)
    padded = F.pad(img[None, None], (pad, pad, pad, pad),
                   mode="replicate")[0, 0]
    table = line_table_2d(patch_size, phi_range)
    h, w = img.shape
    rnc = []
    for t in range(phi_range):
        vmin = vmax = vcenter = None
        for li in range(patch_size):
            di, dj = int(table[t, li, 0]), int(table[t, li, 1])
            v = padded[di:di + h, dj:dj + w]
            vmin = v if vmin is None else torch.minimum(vmin, v)
            vmax = v if vmax is None else torch.maximum(vmax, v)
            if li == pad:
                vcenter = v
        rng = torch.clamp(vmax - vmin, min=1e-8)
        rnc.append((vcenter - vmin) / rng)
    total = rnc[0]
    for r in rnc[1:]:
        total = total + r
    return _lp_cv_combine(torch.stack(rnc, dim=-1),
                          total * np.float32(1.0 / phi_range))


def lp_cv_enhance_2d(image: torch.Tensor, patch_size: int = 11,
                     phi_range: int = 9) -> torch.Tensor:
    """Kernel B2 on a CUDA tensor, the plain version on a CPU tensor."""
    if image.device.type == "cuda":
        return kernels.lpcv2d(image.to(torch.float32).contiguous(),
                              patch_size, phi_range)
    if image.device.type == "cpu":
        return lp_cv_enhance_2d_plain(image, patch_size, phi_range)
    raise ValueError(f"lp_cv_enhance_2d: unsupported device {image.device}")


def lp_cv_enhance_3d_plain(volume: torch.Tensor, patch_size: int = 11,
                           theta_range: int = 9, phi_range: int = 9,
                           chunk_xy: int = 128, bf16: bool = False,
                           layout: str = "xyz") -> torch.Tensor:
    """Plain-torch 3D LP-CV (twin of kernel B6): edge pad, then per
    (chunk_xy, chunk_xy) xy chunk with its halo, per-orientation min/max
    over shifted views, normalized centre samples, combine. The chunks
    bound the (cx, cy, Z, 72) orientation stack; they do not change the
    result. ``bf16``: round the input to bf16 first (min/max of the
    rounded values, ratio and combine in f32), as the reference's bf16
    mode. ``layout``: "xyz" or "xzy" (the 3D pipeline's canonical layout),
    for input and output; the stencil's axes are (x, y, z) either way."""
    if layout not in ("xyz", "xzy"):
        raise ValueError(f"lp_cv_enhance_3d: unknown layout {layout!r}")
    vol = volume.to(torch.float32)
    if layout == "xzy":
        vol = vol.permute(0, 2, 1)
    if bf16:
        vol = vol.to(torch.bfloat16).to(torch.float32)
    x, y, z = vol.shape
    pad = (patch_size - 1) // 2
    padded = F.pad(vol[None, None], (pad,) * 6, mode="replicate")[0, 0]
    table = line_table_3d(patch_size, theta_range, phi_range)
    out = torch.empty((x, y, z), dtype=torch.float32, device=vol.device)
    for x0 in range(0, x, chunk_xy):
        cx = min(chunk_xy, x - x0)
        for y0 in range(0, y, chunk_xy):
            cy = min(chunk_xy, y - y0)
            block = padded[x0:x0 + cx + 2 * pad, y0:y0 + cy + 2 * pad]
            rnc = []
            for t in range(table.shape[0]):
                vmin = vmax = vcen = None
                for li in range(patch_size):
                    dx, dy, dz = (int(v) for v in table[t, li])
                    v = block[dx:dx + cx, dy:dy + cy, dz:dz + z]
                    vmin = v if vmin is None else torch.minimum(vmin, v)
                    vmax = v if vmax is None else torch.maximum(vmax, v)
                    if li == pad:
                        vcen = v
                rnc.append((vcen - vmin)
                           / torch.clamp(vmax - vmin, min=1e-8))
            out[x0:x0 + cx, y0:y0 + cy] = _lp_cv_combine(
                torch.stack(rnc, dim=-1))
    return out.permute(0, 2, 1).contiguous() if layout == "xzy" else out


def lp_cv_enhance_3d(volume: torch.Tensor, patch_size: int = 11,
                     theta_range: int = 9, phi_range: int = 9,
                     chunk_xy: int = 128, bf16: bool | None = None,
                     layout: str = "xyz") -> torch.Tensor:
    """3D LP-CV of an (X, Y, Z) (or, ``layout="xzy"``, (X, Z, Y)) volume,
    f32 out in the same layout: kernel B6 on a CUDA tensor, the plain
    version on a CPU tensor. ``bf16=None`` means bf16 on CUDA and f32 on
    the CPU, as the reference picks bf16 off the CPU backend; ``chunk_xy``
    bounds only the plain version's memory."""
    if layout not in ("xyz", "xzy"):
        raise ValueError(f"lp_cv_enhance_3d: unknown layout {layout!r}")
    if volume.device.type == "cuda":
        v = volume.to(torch.float32)
        if layout == "xyz":
            v = v.permute(0, 2, 1)
        out = kernels.lpcv3d(v.contiguous(), bf16 is not False, patch_size,
                             theta_range, phi_range)
        return out if layout == "xzy" else out.permute(0, 2, 1).contiguous()
    if volume.device.type == "cpu":
        return lp_cv_enhance_3d_plain(volume, patch_size, theta_range,
                                      phi_range, chunk_xy, bool(bf16),
                                      layout)
    raise ValueError(f"lp_cv_enhance_3d: unsupported device {volume.device}")
