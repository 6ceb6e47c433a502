"""Binary morphology (torch port of hiprfish_tpu/ops/morphology.py): the
cross footprint as shifted copies, disks of any radius as an FFT
convolution thresholded at 0.5, hole filling, small-hole removal and the
Sobel magnitude."""

from __future__ import annotations

import math

import numpy as np
import torch

from hiprfish_tpu_torch.ops.labeling import (_id_counts, border_mask,
                                             flood_reach, label, shifted)


def _cross_shifts(ndim: int):
    shifts = []
    for ax in range(ndim):
        for o in (-1, 1):
            off = [0] * ndim
            off[ax] = o
            shifts.append(tuple(off))
    return shifts


def binary_erosion(mask: torch.Tensor) -> torch.Tensor:
    """Erosion with the cross footprint (out-of-image = foreground)."""
    m = mask.to(torch.bool)
    out = m
    for off in _cross_shifts(mask.ndim):
        out = out & shifted(m, off, True)
    return out


def binary_dilation(mask: torch.Tensor) -> torch.Tensor:
    """Dilation with the cross footprint."""
    m = mask.to(torch.bool)
    out = m
    for off in _cross_shifts(mask.ndim):
        out = out | shifted(m, off, False)
    return out


def binary_opening(mask: torch.Tensor) -> torch.Tensor:
    return binary_dilation(binary_erosion(mask))


def binary_closing(mask: torch.Tensor) -> torch.Tensor:
    return binary_erosion(binary_dilation(mask))


def disk_kernel(radius: int) -> np.ndarray:
    """skimage.morphology.disk as float32: pixels within L2 distance
    ``radius`` of the centre."""
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


def binary_dilation_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilation of an (H, W) mask by disk(radius): the linear convolution
    with the disk by rfft2 at (H + 2r, W + 2r) rounded up to even sizes,
    cut back to (H, W) at offset r, then > 0.5. The counts are integers
    (at most ~pi r^2), so the threshold leaves a wide margin against the
    FFT's float32 error."""
    h, w = mask.shape
    k = torch.from_numpy(disk_kernel(radius)).to(mask.device)
    fh, fw = h + k.shape[0] - 1, w + k.shape[1] - 1
    fh += fh % 2
    fw += fw % 2
    fm = torch.fft.rfft2(mask.to(torch.float32), s=(fh, fw))
    fk = torch.fft.rfft2(k, s=(fh, fw))
    conv = torch.fft.irfft2(fm * fk, s=(fh, fw))
    return conv[radius:radius + h, radius:radius + w] > 0.5


def binary_erosion_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    return ~binary_dilation_disk(~mask.to(torch.bool), radius)


def binary_closing_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    return binary_erosion_disk(binary_dilation_disk(mask, radius), radius)


def binary_fill_holes(mask: torch.Tensor, connectivity: int = 1,
                      max_run: int | None = None) -> torch.Tensor:
    """Fill background regions not connected to the border: a
    border-seeded flood through the complement."""
    m = mask.to(torch.bool)
    comp = ~m
    reach = flood_reach(border_mask(mask.shape, mask.device), comp,
                        connectivity, max_run=max_run)
    return m | (comp & ~reach)


def remove_small_holes(mask: torch.Tensor, area_threshold: int = 64,
                       connectivity: int = 1) -> torch.Tensor:
    """Fill holes smaller than ``area_threshold`` (skimage
    remove_small_holes): complement components with no border pixel."""
    m = mask.to(torch.bool)
    comp = ~m
    lbl = label(comp, connectivity)
    flat, counts = _id_counts(lbl)
    touches = torch.zeros(counts.shape, dtype=torch.bool, device=mask.device)
    touches[flat[border_mask(mask.shape, mask.device).reshape(-1)]] = True
    touches[0] = True
    small_hole = (~touches[flat] & (counts[flat] < area_threshold)) \
        .reshape(mask.shape) & comp
    return m | small_hole


def sobel_magnitude(image: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of an (H, W) image over its edge-padded
    border, scaled as skimage.filters.sobel: each 3x3 kernel over 4, the
    magnitude over sqrt(2)."""
    img = image.to(torch.float32)
    h, w = img.shape
    kx = torch.tensor([[1, 0, -1], [2, 0, -2], [1, 0, -1]],
                      dtype=torch.float32, device=img.device) / 4.0
    pad = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                  mode="replicate")[0, 0]

    def conv3(k):
        acc = torch.zeros_like(img)
        for di in range(3):
            for dj in range(3):
                acc = acc + k[di, dj] * pad[di:di + h, dj:dj + w]
        return acc

    gx = conv3(kx.T)
    gy = conv3(kx)
    return torch.sqrt(gx * gx + gy * gy) / math.sqrt(2.0)
