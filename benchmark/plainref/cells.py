"""The per-cell end of the plain reference's steps (a frozen copy of the
arithmetic of hiprfish_tpu_torch's ``pipeline/fused._scatter_last`` and the
row-max normalisation; it imports nothing of the port)."""

from __future__ import annotations

import torch

from .classify import classify
from .precision import Precision


def spectra_and_calls(labels, n_cells, remap, keep, means, clf,
                      p: Precision, max_cells: int) -> dict:
    """The result of one FOV from its final labels: each kept id's mean
    spectrum scattered to its cell's row, row-max normalised, and the calls
    of cells 1..n (``code``, ``prob`` and ``scores`` row i is cell i + 1)."""
    avgint = torch.zeros((max_cells, means.shape[1]), dtype=torch.float32,
                         device=means.device)
    kept = torch.nonzero(keep).squeeze(1)
    dest = remap[kept].to(torch.int64)
    # ids capped at max_cells - 1 collide there: the last one wins
    last = torch.ones_like(dest, dtype=torch.bool)
    last[:-1] = dest[1:] != dest[:-1]
    avgint[dest[last]] = means[kept[last]]
    avgint[0] = 0.0
    rows = min(n_cells, max_cells - 1)
    norm = p.round(avgint / torch.clamp(
        torch.max(avgint, dim=1, keepdim=True).values, min=1e-12))
    code, prob, scores = classify(norm[1:rows + 1], clf, p)
    return {"labels": labels, "n_cells": n_cells, "avgint": avgint,
            "code": code, "prob": prob, "scores": scores}
