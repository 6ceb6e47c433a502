"""Marker-controlled watershed as iterative minimax-cost label propagation
(torch port of hiprfish_tpu/ops/watershed.py)."""

from __future__ import annotations

import torch

from hiprfish_tpu_torch.ops.labeling import _neighbor_shifts, shifted

_BIG = 3.4e38


def watershed(surface: torch.Tensor, markers: torch.Tensor,
              mask: torch.Tensor | None = None, connectivity: int = 1,
              max_iters: int = 1024) -> torch.Tensor:
    """Flood ``surface`` (lower = flooded first) from ``markers`` (int,
    0 = unlabeled) within ``mask``; returns int32 labels.

    Each iteration relaxes cost[p] <- min over neighbors q of
    max(cost[q], surface[p]). Only a strictly better cost wins: the
    incumbent keeps ties, and an unlabelled pixel takes an equal cost.
    Stops when nothing changed or after ``max_iters`` iterations (one host
    sync per iteration for the change test)."""
    surf = surface.to(torch.float32)
    if mask is None:
        mask = torch.ones(surf.shape, dtype=torch.bool, device=surf.device)
    else:
        mask = mask.to(torch.bool)
    markers = markers.to(torch.int32)
    seeded = (markers > 0) & mask
    zeros = torch.zeros_like(markers)
    big = torch.full_like(surf, _BIG)
    labels = torch.where(seeded, markers, zeros)
    cost = torch.where(seeded, surf, big)
    shifts = _neighbor_shifts(surf.ndim, connectivity)
    changed, it = True, 0
    while changed and it < max_iters:
        best_cost = cost
        best_label = labels
        for off in shifts:
            nb_cost = shifted(cost, off, _BIG)
            nb_label = shifted(labels, off, 0)
            cand = torch.maximum(nb_cost, surf)
            better = (nb_label > 0) & (
                (cand < best_cost) | ((cand == best_cost) & (best_label == 0)))
            best_cost = torch.where(better, cand, best_cost)
            best_label = torch.where(better, nb_label, best_label)
        new_labels = torch.where(seeded, markers,
                                 torch.where(mask, best_label, zeros))
        new_cost = torch.where(seeded, surf, torch.where(mask, best_cost, big))
        changed = bool(((new_labels != labels).any()
                        | (new_cost != cost).any()))  # host sync
        labels, cost, it = new_labels, new_cost, it + 1
    return labels
