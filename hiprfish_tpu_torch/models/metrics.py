"""Gated per-laser-block cosine distances as matrix products (torch port of
hiprfish_tpu/models/metrics.py::block_cosine_distance_matrix).

The GEMMs are plain float32 ``torch.matmul``: the pipeline turns TF32 off
where it starts (pipeline/fused.py), so they run in full float32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _block_normalize(a: torch.Tensor, blocks):
    """Per-block L2-normalized copy + (N, B) zero-norm indicators."""
    outs, zs = [], []
    for lo, hi in blocks:
        b = a[:, lo:hi]
        n = torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
        outs.append(torch.where(n > 0, b / torch.clamp(n, min=1e-30),
                                torch.zeros_like(b)))
        zs.append(n[:, 0] == 0)
    return torch.cat(outs, dim=1), torch.stack(zs, dim=1).to(torch.float32)


def block_cosine_distance_matrix(
        x: torch.Tensor, y: torch.Tensor,
        blocks: Tuple[Tuple[int, int], ...],
        check_slice: Tuple[int, int] | None = None) -> torch.Tensor:
    """(N, M) gated block-cosine distances between query rows ``x`` and
    reference rows ``y`` (channels + check bits)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    n_blocks = len(blocks)
    xn, xz = _block_normalize(x, blocks)
    yn, yz = _block_normalize(y, blocks)
    cos_sum = xn @ yn.T
    n_both_zero = xz @ yz.T
    ungated = (n_blocks - cos_sum - n_both_zero) / n_blocks
    if check_slice is None:
        return ungated
    clo, chi = check_slice
    xc = x[:, clo:chi]
    yc = y[:, clo:chi]
    diff = (torch.sum(xc, dim=1)[:, None] + torch.sum(yc, dim=1)[None, :]
            - 2.0 * (xc @ yc.T))
    agree = torch.abs(diff) < 0.01
    n_checks = chi - clo
    gates = torch.stack([xc[:, min(b, n_checks - 1)]
                         for b in range(n_blocks)], dim=1)
    parts = []
    col = 0
    for b, (lo, hi) in enumerate(blocks):
        wid = hi - lo
        parts.append(xn[:, col:col + wid] * gates[:, b][:, None])
        col += wid
    xng = torch.cat(parts, dim=1)
    g_cos = xng @ yn.T
    g_both_zero = (xz * gates) @ yz.T
    g_sum = torch.sum(gates, dim=1)[:, None]
    gated = (g_sum - g_cos - g_both_zero) / n_blocks
    return torch.where(agree, gated, ungated)
