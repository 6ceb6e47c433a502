"""Per-label region properties by scatter-add (torch port of
hiprfish_tpu/ops/regionprops.py, the 2D functions the host engine and the
per-cell measurement run).

Shape properties follow skimage's central-moment definitions: inertia
eigenvalues lambda1 >= lambda2, major_axis = 4*sqrt(lambda1),
eccentricity = sqrt(1 - lambda2/lambda1), orientation in (-pi/2, pi/2]
against the row axis.
"""

from __future__ import annotations

import torch


def _segment_sum(values: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """(num_segments, K) sums of (N, K) ``values`` by (N,) ids; ids outside
    [0, num_segments) add nothing (jax.ops.segment_sum drops them)."""
    keep = torch.nonzero((ids >= 0) & (ids < num_segments)).squeeze(1)
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids[keep], values[keep])


def channel_sums(labels: torch.Tensor, image: torch.Tensor,
                 num_segments: int):
    """((num_segments, C) per-label channel sums, (num_segments, 1) pixel
    counts) of a labels.shape + (C,) image, in float32."""
    ids = labels.reshape(-1).to(torch.int64)
    img = image.reshape(-1, image.shape[-1]).to(torch.float32)
    sums = _segment_sum(img, ids, num_segments)
    counts = _segment_sum(torch.ones((ids.shape[0], 1), dtype=torch.float32,
                                     device=ids.device), ids, num_segments)
    return sums, counts


def mean_intensities(labels: torch.Tensor, image: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """(num_segments, C) per-label mean of every channel of a
    labels.shape + (C,) image in one pass; row 0 is the background and
    rows of absent labels are 0."""
    sums, counts = channel_sums(labels, image, num_segments)
    return sums / torch.clamp(counts, min=1.0)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64, so only the float64
    sum rounds before the float32 cast (a double rounding that differs
    from a true FMA only on exact float32 midpoints)."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def shape_props_2d(labels: torch.Tensor, num_segments: int) -> dict:
    """Per-label 2D shape properties: dict of (num_segments,) tensors area,
    centroid_r, centroid_c, major_axis_length, minor_axis_length,
    eccentricity, orientation.

    The raw moments are int64 sums rounded once to f32, so they are exact
    and the same in every run: f32 sums of r^2 (~4e6 per pixel at 2000^2)
    round in the order the card's atomics add them, and the minor axis
    (mu20 = E[r^2] - E[r]^2 cancels ~1e6 against ~1e6) then moves between
    runs enough to flip a cell at the shape gate."""
    h, w = labels.shape
    ids = labels.reshape(-1).to(torch.int64)
    dev = labels.device
    rows = torch.arange(h, dtype=torch.int64, device=dev)[:, None] \
        .expand(h, w).reshape(-1)
    cols = torch.arange(w, dtype=torch.int64, device=dev)[None, :] \
        .expand(h, w).reshape(-1)
    feats = torch.stack([torch.ones_like(rows), rows, cols, rows * rows,
                         cols * cols, rows * cols], dim=-1)
    sums = _segment_sum(feats, ids, num_segments).to(torch.float32)
    n = torch.clamp(sums[:, 0], min=1.0)
    rbar = sums[:, 1] / n
    cbar = sums[:, 2] / n
    # central second moments over the area, with skimage's +1/12 pixel
    # extent in the inertia tensor; E[r^2] - rbar^2 and the discriminant
    # round once per multiply-add, as the reference's compiled program
    # (which contracts them into FMAs) does: the cancellation in mu20
    # turns a rounding step into ~1e-5 of the axis lengths
    mu20 = _fma(-rbar, rbar, sums[:, 3] / n) + 1.0 / 12.0
    mu02 = _fma(-cbar, cbar, sums[:, 4] / n) + 1.0 / 12.0
    mu11 = _fma(-rbar, cbar, sums[:, 5] / n)
    d = mu20 - mu02
    common = torch.sqrt(torch.clamp(_fma(d, d, 4 * mu11 * mu11), min=0.0))
    lam1 = torch.clamp((mu20 + mu02 + common) / 2.0, min=1e-12)
    lam2 = torch.clamp((mu20 + mu02 - common) / 2.0, min=0.0)
    return {
        "area": sums[:, 0],
        "centroid_r": rbar,
        "centroid_c": cbar,
        "major_axis_length": 4.0 * torch.sqrt(lam1),
        "minor_axis_length": 4.0 * torch.sqrt(lam2),
        "eccentricity": torch.sqrt(torch.clamp(1.0 - lam2 / lam1, 0.0, 1.0)),
        "orientation": 0.5 * torch.atan2(-2.0 * mu11, mu20 - mu02),
    }
