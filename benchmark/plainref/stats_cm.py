"""Frozen copy of the plain channels-major per-label sums of
hiprfish_tpu_torch/ops/segstats.py (``stats_cm_plain``, the twin of kernel
B5) for the benchmark's plain reference; it imports nothing of the port."""

from __future__ import annotations

import torch


def stats_cm(labels: torch.Tensor, image: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """The (num_segments, 1 + C) f32 [count, channel sums] table of
    (n,) labels over a channels-major (C, n) image, in float32; ids
    outside [1, num_segments) add nothing."""
    ids = labels.reshape(-1).to(torch.int64)
    image = image.reshape(image.shape[0], ids.shape[0])
    sel = torch.nonzero((ids > 0) & (ids < num_segments)).squeeze(1)
    ids = ids[sel]
    acc = torch.zeros((1 + image.shape[0], num_segments), dtype=torch.float32,
                      device=labels.device)
    acc[0].index_add_(0, ids, torch.ones(ids.shape, dtype=torch.float32,
                                         device=labels.device))
    acc[1:].index_add_(1, ids, image[:, sel].to(torch.float32))
    return acc.T.contiguous()
