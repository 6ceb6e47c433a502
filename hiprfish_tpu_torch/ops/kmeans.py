"""Histogram Lloyd KMeans for 1-D intensity clustering (torch port of
hiprfish_tpu/ops/kmeans.py).

On the CPU the histogram's bin sums are sequential f32 sums, as the
reference's, and the masks equal the reference's. On CUDA an f32
``index_add_`` would add in the atomics' run-dependent order, so the bins
are summed in fixed point instead (``fp.segment_sum``): each value's
offset from the minimum as an int64 multiple of span / 2^40, summed exactly
in any order and rounded once to f32. Two calls on the card then give the
same centres bitwise. Against the CPU the bins differ by a few ulps (one
rounding instead of a sequential sum), so the centres and the
brightest-cluster threshold move by a few ulps, and only pixels within
those ulps of the threshold can change side.
"""

from __future__ import annotations

import torch

from hiprfish_tpu_torch.ops import fp

# fixed-point resolution of the card's bin sums: a value's offset from the
# minimum is rounded to a multiple of span / 2^40; at most 2^19 + 512 values
# of at most ~2^40 each keep every int64 sum below 2^60
FIX_BITS = 40


def _value_histogram(values: torch.Tensor, n_bins: int):
    """(counts, bin_val, vmin, vmax, span) over a subsample of whole
    512-value blocks at a row stride once there are more than 2^19
    values; the bin sums are sequential f32 on the CPU and fixed point
    (order-free) on CUDA."""
    v = values.reshape(-1).to(torch.float32)
    vmin = torch.min(v)
    vmax = torch.max(v)
    span = torch.clamp(vmax - vmin, min=1e-12)
    max_hist = 1 << 19
    if v.shape[0] > max_hist:
        blk = 512
        nb = v.shape[0] // blk
        stride = -(-nb * blk // max_hist)
        vs = v[:nb * blk].reshape(nb, blk)[::stride].reshape(-1)
    else:
        vs = v
    idx = torch.clamp(((vs - vmin) / span * (n_bins - 1)).to(torch.int32),
                      0, n_bins - 1)
    counts, sums = fp.segment_sum(vs[:, None], idx, n_bins, span=span,
                                  offset=vmin, bits=FIX_BITS)
    sums = sums[:, 0]
    bin_centers = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1.0),
                              torch.zeros_like(sums))
    ar = torch.arange(n_bins, dtype=torch.float32, device=v.device)
    bin_pos = vmin + (ar + 0.5) / n_bins * span
    bin_val = torch.where(counts > 0, bin_centers, bin_pos)
    return counts, bin_val, vmin, vmax, span


def _lloyd_from_histogram(counts, bin_val, vmin, vmax, span, k: int,
                          iters: int) -> torch.Tensor:
    """Lloyd over a fixed histogram from three deterministic starts
    (histogram quantiles, value-range spread, max-anchored), keeping the
    lowest inertia; sorted-ascending centres."""
    n_bins = counts.shape[0]
    dev = counts.device
    qs = (torch.arange(k, dtype=torch.float32, device=dev) + 0.5) / k
    cdf = torch.cumsum(counts, dim=0)
    qbins = torch.searchsorted(cdf, qs * cdf[-1])
    quant = bin_val[torch.clamp(qbins, 0, n_bins - 1)]
    centers = torch.stack(
        [quant, vmin + qs * span, torch.cat([quant[:-1], vmax[None]])])
    # the three starts run as one batch: centers (3, k)
    cnt = counts[None, :, None]
    bv = bin_val[None, :, None]
    for _ in range(iters):
        d = torch.abs(bv - centers[:, None, :])
        assign = torch.argmin(d, dim=2)
        one_hot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        wgt = one_hot * cnt
        wsum = wgt.sum(1)
        new = (wgt * bv).sum(1) / torch.clamp(wsum, min=1e-12)
        centers = torch.where(wsum > 0, new, centers)
    d = torch.abs(bv - centers[:, None, :])
    inertia = torch.sum(counts[None, :] * torch.min(d, dim=2).values ** 2,
                        dim=1)
    best = centers[torch.argmin(inertia)]
    return torch.sort(best).values


def kmeans1d_centers(values: torch.Tensor, k: int, iters: int = 40,
                     n_bins: int = 2048) -> torch.Tensor:
    """Sorted-ascending cluster centres of the values."""
    return _lloyd_from_histogram(*_value_histogram(values, n_bins), k, iters)


def kmeans1d(values: torch.Tensor, k: int, iters: int = 40,
             n_bins: int = 2048):
    """(int32 labels of the values' shape, sorted-ascending centres): each
    value takes its nearest centre, the lower index on a tie."""
    centers = kmeans1d_centers(values, k, iters, n_bins)
    v = values.reshape(-1).to(torch.float32)
    labels = torch.argmin(torch.abs(v[:, None] - centers[None, :]), dim=1)
    return labels.reshape(values.shape).to(torch.int32), centers


def darkest_cluster_mask(image: torch.Tensor, k: int = 2,
                         iters: int = 40) -> torch.Tensor:
    """Boolean mask of the values nearest the lowest centre."""
    labels, _ = kmeans1d(image, k, iters)
    return labels == 0


def brightest_cluster_mask(image: torch.Tensor, k: int = 2,
                           iters: int = 40) -> torch.Tensor:
    """Boolean mask of the cluster with the highest centre:
    value >= midpoint of the two highest centres."""
    centers = kmeans1d_centers(image, k, iters)
    return image >= (centers[-1] + centers[-2]) / 2.0


def kmeans1d_centers_multi(values: torch.Tensor, ks, iters: int = 40,
                           n_bins: int = 2048) -> tuple:
    """Sorted centres for each k in ``ks`` over ONE shared histogram of the
    values (the 3D engine's k=2 foreground and k=3 interior thresholds)."""
    hist = _value_histogram(values, n_bins)
    return tuple(_lloyd_from_histogram(*hist, k, iters) for k in ks)


def brightest_cluster_masks(image: torch.Tensor, ks=(2, 3),
                            iters: int = 40) -> tuple:
    """brightest_cluster_mask for each k in ``ks``, sharing one histogram
    (the E. coli engines' k=2 foreground and k=3 interior)."""
    all_centers = kmeans1d_centers_multi(image, tuple(ks), iters)
    return tuple(image >= (c[-1] + c[-2]) / 2.0 for c in all_centers)
