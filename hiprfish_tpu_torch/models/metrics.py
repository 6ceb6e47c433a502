"""Gated per-laser-block cosine distances as matrix products (torch port of
hiprfish_tpu/models/metrics.py::block_cosine_distance_matrix), and the
metric's blocks and check columns of a layout (``metric_for_layout``).

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


def metric_for_layout(layout, violet_derivative: bool = False):
    """(blocks, check_slice) of the gated metric of a channel layout: the
    layout's laser blocks, then with ``violet_derivative`` the block of
    np.diff of the first one, and one check column per metric block (the
    10-bit layout: 5 without the derivative block, 6 with it; the 7-bit
    layout: 4)."""
    blocks = list(layout.blocks)
    c = layout.n_channels
    if violet_derivative:
        first = layout.blocks[0]
        d = first[1] - first[0] - 1  # np.diff width of the first block
        blocks = blocks + [(c, c + d)]
        c = c + d
    n_checks = min(len(layout.check_bit_groups), len(blocks))
    return tuple(blocks), (c, c + n_checks)
