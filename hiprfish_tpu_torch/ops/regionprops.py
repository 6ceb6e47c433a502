"""Per-label region properties by scatter (torch port of
hiprfish_tpu/ops/regionprops.py).

Shape properties follow skimage's central-moment definitions: inertia
eigenvalues lambda1 >= lambda2, major_axis = 4*sqrt(lambda1),
eccentricity = sqrt(1 - lambda2/lambda1), orientation in (-pi/2, pi/2]
against the row axis.
"""

from __future__ import annotations

import torch

from hiprfish_tpu_torch.ops import fp


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
    counts) of a labels.shape + (C,) image, in float32: in pixel order on
    the CPU, as the reference's, and the same bits in every run on the
    card (fp.segment_sum)."""
    counts, sums = fp.segment_sum(
        image.reshape(-1, image.shape[-1]).to(torch.float32),
        labels.reshape(-1).to(torch.int64), num_segments)
    return sums, counts[:, None]


def mean_intensities(labels: torch.Tensor, image: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """(num_segments, C) per-label mean of every channel of a
    labels.shape + (C,) image in one pass; row 0 is the background and
    rows of absent labels are 0."""
    sums, counts = channel_sums(labels, image, num_segments)
    return sums / torch.clamp(counts, min=1.0)


def max_intensities(labels: torch.Tensor, image: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(num_segments, C) per-label maximum of every channel, as
    jax.ops.segment_max: -inf for labels with no pixel, and pixels whose
    label lies outside [0, num_segments) dropped."""
    ids = labels.reshape(-1).to(torch.int64)
    img = image.reshape(-1, image.shape[-1]).to(torch.float32)
    keep = torch.nonzero((ids >= 0) & (ids < num_segments)).squeeze(1)
    out = torch.full((num_segments, img.shape[1]), -torch.inf,
                     dtype=torch.float32, device=img.device)
    idx = ids[keep][:, None].expand(-1, img.shape[1])
    return out.scatter_reduce_(0, idx, img[keep], reduce="amax")


def label_overlap_any(labels: torch.Tensor, mask: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """(num_segments,) bool: does any pixel of the label lie in ``mask``
    (labels outside [0, num_segments) dropped)."""
    ids = labels.reshape(-1).to(torch.int64)
    sel = mask.reshape(-1).to(torch.bool) & (ids >= 0) & (ids < num_segments)
    hit = torch.zeros(num_segments, dtype=torch.bool, device=labels.device)
    hit[ids[sel]] = True
    return hit


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
    # turns a rounding step into ~1e-5 of the axis lengths; the square
    # roots are correctly rounded, as the reference's are
    mu20 = fp.fma(-rbar, rbar, sums[:, 3] / n) + 1.0 / 12.0
    mu02 = fp.fma(-cbar, cbar, sums[:, 4] / n) + 1.0 / 12.0
    mu11 = fp.fma(-rbar, cbar, sums[:, 5] / n)
    d = mu20 - mu02
    common = fp.sqrt(torch.clamp(fp.fma(4 * mu11, mu11, d * d), min=0.0))
    lam1 = torch.clamp((mu20 + mu02 + common) / 2.0, min=1e-12)
    lam2 = torch.clamp((mu20 + mu02 - common) / 2.0, min=0.0)
    return {
        "area": sums[:, 0],
        "centroid_r": rbar,
        "centroid_c": cbar,
        "major_axis_length": 4.0 * fp.sqrt(lam1),
        "minor_axis_length": 4.0 * fp.sqrt(lam2),
        "eccentricity": fp.sqrt(torch.clamp(1.0 - lam2 / lam1, 0.0, 1.0)),
        "orientation": 0.5 * fp.atan2(-2.0 * mu11, mu20 - mu02),
    }


def shape_props_3d(labels: torch.Tensor, num_segments: int) -> dict:
    """Per-label 3D area and centroid: dict of (num_segments,) float32
    tensors area, centroid_x, centroid_y, centroid_z of an (X, Y, Z) label
    image.

    The counts and coordinate sums are int64 on every device, rounded once
    to float32 and divided once. The reference sums float32 in pixel
    order, which is exact while a sum stays below 2^24 (a cell of 5,800
    voxels at coordinates up to 1,039 sums to ~6.0e6), so the two agree
    bit for bit on every such label, and the card needs no float32
    atomics."""
    x, y, z = labels.shape
    ids = labels.reshape(-1).to(torch.int64)
    dev = labels.device
    xi = torch.arange(x, dtype=torch.int64, device=dev)[:, None, None]
    yi = torch.arange(y, dtype=torch.int64, device=dev)[None, :, None]
    zi = torch.arange(z, dtype=torch.int64, device=dev)[None, None, :]
    feats = torch.stack([torch.ones_like(ids), xi.expand(x, y, z).reshape(-1),
                         yi.expand(x, y, z).reshape(-1),
                         zi.expand(x, y, z).reshape(-1)], dim=-1)
    sums = _segment_sum(feats, ids, num_segments).to(torch.float32)
    n = torch.clamp(sums[:, 0], min=1.0)
    return {
        "area": sums[:, 0],
        "centroid_x": sums[:, 1] / n,
        "centroid_y": sums[:, 2] / n,
        "centroid_z": sums[:, 3] / n,
    }
