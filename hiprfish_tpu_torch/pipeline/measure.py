"""Per-cell spectral measurement (torch port of
hiprfish_tpu/pipeline/measure.py): the mean spectrum of every cell across
every channel in one scatter-add pass, and the FOV's artifact writer."""

from __future__ import annotations

import numpy as np
import torch

from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.ops import regionprops as rp


def measure_device(labels: torch.Tensor, image: torch.Tensor,
                   max_cells: int):
    """(max_cells, C) per-cell mean spectra (row 0 = background slot) and
    their row-max normalised copy. The copy is sums / (count x row max),
    one division, as the reference's compiled program folds its two."""
    sums, counts = rp.channel_sums(labels, image, max_cells)
    counts = torch.clamp(counts, min=1.0)
    avg = sums / counts
    row_max = torch.clamp(torch.max(avg, dim=1, keepdim=True).values,
                          min=1e-12)
    return avg, sums / (counts * row_max)


def measure_fov(segmentation: torch.Tensor, registered: torch.Tensor,
                n_cells, max_cells: int = 4096):
    """(avgint, avgint_norm) as numpy arrays of shape (n_cells, C), rows
    ordered by label id."""
    avg, norm = measure_device(segmentation, registered, max_cells)
    n = int(n_cells)
    return avg[1:n + 1].cpu().numpy(), norm[1:n + 1].cpu().numpy()


def save_measurement(sample: str, avgint: np.ndarray, avgint_norm: np.ndarray,
                     segmentation, with_header: bool = False) -> None:
    """Persist the measurement artifacts of one FOV: _avgint.csv,
    _avgint_norm.csv (headerless, or with_header=True for the
    synthetic-community style), _seg.npy and _seg.png."""
    outputs.save_avgint_csv(sample + "_avgint.csv", avgint)
    if with_header:
        outputs.save_avgint_norm_csv_with_header(
            sample + "_avgint_norm.csv", avgint_norm)
    else:
        outputs.save_avgint_csv(sample + "_avgint_norm.csv", avgint_norm)
    outputs.save_segmentation(np.asarray(segmentation), sample)
