"""2D LP-CV edge enhancement (torch port of hiprfish_tpu/ops/line_profile.py).

``lp_cv_enhance_2d`` is the wrapper of kernel B2 (csrc/lpcv2d.cu), which
holds the patch_size=11, phi_range=9 offset table as constants. The table
is built in numpy here for the plain version: the reference's module imports
jax, so its ``line_table_2d`` cannot be imported where jax is absent (tests
hold this table and the kernel's equal to the reference's).
"""

from __future__ import annotations

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


def _lp_cv_combine(rnc_stack: torch.Tensor) -> torch.Tensor:
    """mean(rnc) * (1 - quartile CV) over the last axis (T orientations)."""
    t = rnc_stack.shape[-1]
    mean = torch.mean(rnc_stack, dim=-1)
    s = torch.sort(rnc_stack, dim=-1).values
    q25, q75 = 0.25 * (t - 1), 0.75 * (t - 1)
    lo25, hi25 = int(np.floor(q25)), int(np.ceil(q25))
    lo75, hi75 = int(np.floor(q75)), int(np.ceil(q75))
    f25, f75 = q25 - lo25, q75 - lo75
    lq = s[..., lo25] * (1 - f25) + s[..., hi25] * f25
    uq = s[..., lo75] * (1 - f75) + s[..., hi75] * f75
    qcv = torch.where(uq > 0, (uq - lq) / (uq + lq + 1e-8),
                      torch.zeros_like(uq))
    return mean * (1.0 - qcv)


def lp_cv_enhance_2d_plain(image: torch.Tensor, patch_size: int = 11,
                           phi_range: int = 9) -> torch.Tensor:
    """Plain-torch LP-CV: edge pad, per-orientation min/max/centre over
    shifted views, normalize, combine."""
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
    return _lp_cv_combine(torch.stack(rnc, dim=-1))


def lp_cv_enhance_2d(image: torch.Tensor, patch_size: int = 11,
                     phi_range: int = 9) -> torch.Tensor:
    """Kernel B2 on a CUDA tensor, the plain version on a CPU tensor."""
    if image.device.type == "cuda":
        if (patch_size, phi_range) != (11, 9):
            raise ValueError("lp_cv_enhance_2d: kernel B2 is built for "
                             "patch_size=11, phi_range=9")
        return kernels.lpcv2d(image.to(torch.float32).contiguous())
    if image.device.type == "cpu":
        return lp_cv_enhance_2d_plain(image, patch_size, phi_range)
    raise ValueError(f"lp_cv_enhance_2d: unsupported device {image.device}")
