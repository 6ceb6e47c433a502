"""Per-cell spectral measurement (torch port of
hiprfish_tpu/pipeline/measure.py without its artifact writer): the mean
spectrum of every cell across every channel in one scatter-add pass."""

from __future__ import annotations

import torch

from hiprfish_tpu_torch.ops import regionprops as rp


def measure_device(labels: torch.Tensor, image: torch.Tensor,
                   max_cells: int):
    """(max_cells, C) per-cell mean spectra (row 0 = background slot) and
    their row-max normalised copy."""
    avg = rp.mean_intensities(labels, image, max_cells)
    norm = avg / torch.clamp(torch.max(avg, dim=1, keepdim=True).values,
                             min=1e-12)
    return avg, norm


def measure_fov(segmentation: torch.Tensor, registered: torch.Tensor,
                n_cells, max_cells: int = 4096):
    """(avgint, avgint_norm) as numpy arrays of shape (n_cells, C), rows
    ordered by label id."""
    avg, norm = measure_device(segmentation, registered, max_cells)
    n = int(n_cells)
    return avg[1:n + 1].cpu().numpy(), norm[1:n + 1].cpu().numpy()
