"""Frozen copy of hiprfish_tpu_torch/ops/morphology.py for the benchmark's
plain reference, cut to what the reference calls; it imports nothing of
the port.

Binary morphology (torch port of hiprfish_tpu/ops/morphology.py): the
cross footprint as shifted copies, and hole filling."""

from __future__ import annotations

import torch

from .labeling import border_mask, flood_reach, shifted


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


def binary_fill_holes(mask: torch.Tensor, connectivity: int = 1,
                      max_run: int | None = None) -> torch.Tensor:
    """Fill background regions not connected to the border: a
    border-seeded flood through the complement."""
    m = mask.to(torch.bool)
    comp = ~m
    reach = flood_reach(border_mask(mask.shape, mask.device), comp,
                        connectivity, max_run=max_run)
    return m | (comp & ~reach)
