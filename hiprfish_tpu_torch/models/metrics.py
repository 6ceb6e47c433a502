"""Gated per-laser-block cosine distances as matrix products (torch port of
hiprfish_tpu/models/metrics.py::block_cosine_distance_matrix), the
metric's blocks and check columns of a layout (``metric_for_layout``), and
the reference's pickled UMAP metrics as matrices
(``reference_metric_matrix``, with ``block_chi_distance_matrix`` and
``correlation_distance_matrix``).

The GEMMs are plain float32 ``torch.matmul``: the pipeline turns TF32 off
where it starts (pipeline/fused.py, models/umap_infer.py), so they run in
full float32. The reference metrics sum their dot products and norms in
float64 one channel at a time in channel order (chi-square in float32,
likewise) and round once, so a UMAP's neighbours are the same on the CPU
and the card. Every metric's column j depends on
reference row j alone, so the metrics can be evaluated over chunks of
reference rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# The reference's pickled UMAP metrics as matrices (the port of
# hiprfish_tpu/models/metrics.py:28-41 and :126-268)
# ---------------------------------------------------------------------------


def _products64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in float64, summed one column at a time in column order.
    Each product of two float32 values is exact in float64, so every step
    is one IEEE rounding in a fixed order: the same bits on every device
    (a GEMM sums in its library's order, and a one-ulp difference reorders
    near-tied neighbours)."""
    a, b = a.double(), b.double()
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64,
                      device=a.device)
    for c in range(a.shape[1]):
        out.addcmul_(a[:, c:c + 1], b[None, :, c])
    return out


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """_products64 rounded once to float32."""
    return _products64(a, b).float()


def _sumsq64(a: torch.Tensor) -> torch.Tensor:
    """Row sums of squares as _dot64 sums them, in float64."""
    a = a.double()
    out = torch.zeros(a.shape[0], dtype=torch.float64, device=a.device)
    for c in range(a.shape[1]):
        out.addcmul_(a[:, c], a[:, c])
    return out


def _over(n) -> float:
    """1 / n in float32: x / n as x * (1 / n), as XLA folds a division by
    a constant. Multiplying by it rounds alike on every device; PyTorch's
    CUDA division by a host scalar also multiplies by its reciprocal, its
    CPU division does not."""
    return float(np.float32(1.0) / np.float32(n))


def _norm64(a: torch.Tensor) -> torch.Tensor:
    """Row L2 norms: _sumsq64 rounded once to float32, then the correctly
    rounded float32 square root, taken in float64 (PyTorch's float32 sqrt
    on the card is not correctly rounded; a float64 square root rounded to
    float32 is)."""
    return torch.sqrt(_sumsq64(a).float().double()).float()


def _block_cosine_dist(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """(N, M) cosine distances between block slices: 0 where both rows are
    zero, 1 where exactly one is."""
    nx, ny = _norm64(xb), _norm64(yb)
    dots = _dot64(xb, yb)
    denom = nx[:, None] * ny[None, :]
    cos = torch.where(denom > 0, dots / torch.clamp(denom, min=1e-30),
                      torch.zeros_like(dots))
    dist = 1.0 - cos
    zx, zy = (nx == 0)[:, None], (ny == 0)[None, :]
    dist = torch.where(zx & zy, torch.zeros_like(dist), dist)
    return torch.where(zx ^ zy, torch.ones_like(dist), dist)


def _chi_sum(x: torch.Tensor, y: torch.Tensor, lo: int, hi: int,
             floor: float) -> torch.Tensor:
    """(N, M) sum over channels lo..hi-1 of (x - y)^2 / max(x + y, floor),
    one channel at a time in channel order (no (N, M, C) temporary, and
    the same order on every device)."""
    out = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for c in range(lo, hi):
        xc, yc = x[:, c:c + 1], y[None, :, c]
        out += (xc - yc) ** 2 / torch.clamp(xc + yc, min=floor)
    return out


def block_chi_distance_matrix(x: torch.Tensor, y: torch.Tensor,
                              blocks: Tuple[Tuple[int, int], ...]
                              ) -> torch.Tensor:
    """(N, M) chi-square block distance (channel_chi_intensity_7b): per
    block sum (x - y)^2 / (x + y), averaged over the blocks."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    out = 0.0
    for lo, hi in blocks:
        out = out + _chi_sum(x, y, lo, hi, 1e-12)
    return out * _over(len(blocks))


def correlation_distance_matrix(x: torch.Tensor,
                                y: torch.Tensor) -> torch.Tensor:
    """(N, M) 1 - Pearson correlation (channel_correlation): centred,
    normalised rows and their dot products, in float64 with the sums in
    column order (as _products64), rounded once."""
    def unit(a):
        a = a.double()
        c = a - (sum(a[:, j] for j in range(a.shape[1]))
                 / a.shape[1])[:, None]
        return c / torch.clamp(torch.sqrt(_sumsq64(c)), min=1e-30)[:, None]

    return (1.0 - _products64(unit(x), unit(y))).float()


_REF_BLOCKS_10B = ((0, 32), (32, 55), (55, 75), (75, 89), (89, 95))
_REF_BLOCKS_7B = ((0, 23), (23, 43), (43, 57), (57, 63))


def _check_disagreement(xc: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
    """(N, M) sum |xc - yc| of 0/1 check bits, as one GEMM."""
    return (torch.sum(xc, dim=1)[:, None] + torch.sum(yc, dim=1)[None, :]
            - 2.0 * (xc @ yc.T))


def _ref_gated_cosine_matrix(x, y, blocks, check_slice, gate_bits, scale,
                             disagree_mode):
    """The reference's gated block-cosine numba metrics as a matrix: pairs
    whose check bits agree (sum |diff| < 0.01) take the block distances
    with block b zeroed where x's bit ``gate_bits[b]`` is 0 (None: never),
    scaled by ``scale``; disagreeing pairs take 1.0 (``"one"``) or the
    ungated block distances plus a derivative term of 1.0, over
    n_blocks + 1 (``"ungated_deriv1"``)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dists = [_block_cosine_dist(x[:, lo:hi], y[:, lo:hi])
             for (lo, hi) in blocks]
    clo, chi = check_slice
    xc = x[:, clo:chi]
    agree = torch.abs(_check_disagreement(xc, y[:, clo:chi])) < 0.01
    gated = sum(d if g is None else d * xc[:, g][:, None]
                for d, g in zip(dists, gate_bits))
    if disagree_mode == "ungated_deriv1":
        n = len(blocks) + 1
        agree_val = gated * _over(n)
        disagree_val = (sum(dists) + 1.0) * _over(n)
    else:
        agree_val = gated * _over(len(blocks))
        disagree_val = torch.ones_like(agree_val)
    # the 0.5 of the *_v2 7-bit metrics scales only the agreeing branch
    return torch.where(agree, scale * agree_val, disagree_val)


def _ref_chi_matrix(x, y, check_slice, denom):
    """channel_chi_intensity_7b: chi-square over the raw channels / denom,
    1.0 where the check bits disagree."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    clo, chi = check_slice
    d = _chi_sum(x, y, 0, clo, 1e-30) * _over(denom)
    agree = torch.abs(_check_disagreement(x[:, clo:chi],
                                          y[:, clo:chi])) < 0.01
    return torch.where(agree, d, torch.ones_like(d))


def reference_metric_matrix(name: str):
    """distance_fn(q, train) -> (Q, N) for the reference numba metric
    ``name`` recorded in a pickled UMAP; KeyError for any other name."""
    B10, B7 = _REF_BLOCKS_10B, _REF_BLOCKS_7B
    table = {
        "channel_cosine_intensity": lambda q, r: _ref_gated_cosine_matrix(
            q, r, B10, (95, 100), (0, 1, 2, None, None), 1.0, "one"),
        "channel_cosine_intensity_violet_derivative_v2":
            lambda q, r: _ref_gated_cosine_matrix(
                q, r, B10, (126, 132), (0, 1, 2, 3, 4), 1.0,
                "ungated_deriv1"),
        "channel_cosine_intensity_7b": lambda q, r: _ref_gated_cosine_matrix(
            q, r, B7, (63, 67), (0, 1, 2, 3), 1.0, "one"),
        "channel_cosine_intensity_7b_v2":
            lambda q, r: _ref_gated_cosine_matrix(
                q, r, B7, (63, 67), (0, 1, 2, 3), 0.5, "one"),
        "channel_cosine_intensity_normal":
            lambda q, r: block_cosine_distance_matrix(q, r, B10, None),
        "channel_chi_intensity_7b":
            lambda q, r: _ref_chi_matrix(q, r, (63, 67), 63.0),
        "channel_correlation": correlation_distance_matrix,
    }
    return table[name]
