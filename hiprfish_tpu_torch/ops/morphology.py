"""Binary morphology with the cross footprint, hole filling and small-hole
removal (torch port of hiprfish_tpu/ops/morphology.py, the parts the 2D and
3D slices run)."""

from __future__ import annotations

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
