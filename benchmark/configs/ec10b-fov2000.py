"""Plain reference of ``ec10b-fov2000``: the 10-bit E. coli step from raw
per-laser planes to per-cell barcode calls, in plain torch on any device
(the semantics of hiprfish_tpu_torch's ``pipeline/fused_ecoli.
fov_step_ecoli``, built from the frozen copies in ``benchmark/plainref``;
it imports nothing of the port).

FFT registration on the per-laser max projections -> log-sum image ->
KMeans (k = 2 foreground, k = 3 interior) -> small holes -> opening ->
erosion-depth seeds (CCL + rank, 39 erosions, a per-component depth
histogram, a 4-connected fragment filter) -> watershed -> one stats pass
with moments over the double-eroded cells -> size, border and minor-axis
gates, relabel -> mean spectra -> violet features, check heads, kNN vote.
"""

from __future__ import annotations

import torch

from plainref import kmeans as km
from plainref import labeling as lab
from plainref import morphology as morph
from plainref import register as reg
from plainref import segstats
from plainref import watershed as ws
from plainref.cells import spectra_and_calls
from plainref.precision import Precision


def register(stack, cfg: dict, p: Precision):
    """(registered cube masked by the lasers' overlap, log-sum image)."""
    h, w = stack[0].shape[0], stack[0].shape[1]
    c = cfg["register_crop"]
    if c and h > c and w > c:
        r0, c0 = (h - c) // 2, (w - c) // 2
        crop = lambda im: im[r0:r0 + c, c0:c0 + c]  # noqa: E731
    else:
        crop = lambda im: im  # noqa: E731
    projections = [torch.amax(crop(img), dim=2) for img in stack]
    cref = projections[0]
    reg_dt = getattr(torch, cfg["registered_dtype"])
    sums2d = [p.round(torch.sum(img, dim=2)) for img in stack]
    parts = [stack[0].to(reg_dt)]
    fov_sum = sums2d[0]
    overlap = torch.ones((h, w), dtype=torch.bool, device=cref.device)
    for i in range(1, len(stack)):
        s = reg.register_translation(cref, projections[i])
        if cfg["clamp_shift"]:
            s = reg.clamp_shift(s, cfg["max_shift"])
        shifted, mask = reg.apply_shift_2d(stack[i].to(reg_dt), s)
        parts.append(shifted)
        fov_sum = p.round(fov_sum + reg.apply_shift_2d(sums2d[i], s)[0])
        overlap = overlap & mask
    registered = torch.cat(parts, dim=2) * overlap[:, :, None].to(reg_dt)
    fov_sum = fov_sum * overlap
    return registered, p.round(torch.log(fov_sum + 1e-2))


def seed_markers(interior, cfg: dict, pre: int):
    """Sequential watershed markers of the cell interior by erosion
    depth: each component seeds at the first erosion count whose area
    drops below seed_area_max."""
    cap = cfg["scan_cap"]
    iters = cfg["ccl_max_iters"]
    comp0, _ = segstats.rank_labels(lab.label(interior, 2, iters, cap), 2,
                                    iters, cap)
    comp0 = torch.clamp(comp0, max=pre - 1)
    kmax = cfg["max_erosion_iters"]
    m = interior
    depth = interior.to(torch.int32)
    for _ in range(kmax - 1):
        m = morph.binary_erosion(m) & interior
        depth = depth + m
    depth_c = torch.clamp(depth, 0, kmax)
    dstats = segstats.label_stats(comp0, None, pre, aux=depth_c,
                                  aux_classes=kmax + 1)
    hist = dstats.aux_hist
    area_k = torch.flip(torch.cumsum(torch.flip(hist, [1]), dim=1),
                        [1])[:, 1:]
    small = area_k < cfg["seed_area_max"]
    k_seed = torch.argmax(small.to(torch.int32), dim=1)
    seed_area = torch.gather(area_k, 1, k_seed[:, None])[:, 0]
    ids = torch.arange(pre, device=interior.device)
    valid_seed = (seed_area >= cfg["seed_min_size"]) \
        & (dstats.counts >= 50) & (ids > 0)
    ktbl = torch.where(valid_seed, k_seed,
                       torch.full_like(k_seed, kmax + 1)).to(torch.float32)
    k_pix = segstats.label_lookup(comp0, ktbl)
    seed_mask = (depth.to(torch.float32) > k_pix) & (comp0 > 0)
    lbl4, _ = segstats.rank_labels(lab.label(seed_mask, 1, iters, cap), 1,
                                   iters, cap)
    lbl4 = torch.clamp(lbl4, max=pre - 1)
    st4 = segstats.label_stats(lbl4, None, pre)
    keep4 = (st4.counts >= cfg["seed_min_size"]).to(torch.float32)
    keep4[0] = 0.0
    seed_mask = seed_mask & (segstats.label_lookup(lbl4, keep4) > 0.5)
    markers, _ = segstats.rank_labels(lab.label(seed_mask, 2, iters, cap), 2,
                                      iters, cap)
    return torch.clamp(markers, max=pre - 1)


def run(stack, clf, cfg: dict, max_cells: int, p: Precision) -> dict:
    """Labels, cell count, mean spectra and calls of one FOV."""
    registered, image_cn = register(stack, cfg, p)
    fg, interior = km.brightest_cluster_masks(image_cn, (2, 3),
                                              cfg["kmeans_iters"])
    interior = segstats.remove_small_holes_fast(
        interior, 64, flood_max_run=64)
    interior = morph.binary_opening(interior)
    pre = 2 * max_cells
    markers = seed_markers(interior, cfg, pre)
    seg_ws = ws.watershed(-image_cn, markers, fg, 1,
                          cfg["watershed_max_iters"])
    eroded = segstats.erode_labels_twice(seg_ws)
    s1 = segstats.label_stats(seg_ws, registered, pre, moments=True,
                              image_mask=(eroded > 0).to(torch.float32))
    counts_e = s1.mask_counts
    keep = (s1.counts >= cfg["cell_min_size"]) & (s1.border_hits == 0)
    n = torch.clamp(s1.counts, min=1.0)
    rbar = s1.moments[:, 0] / n
    cbar = s1.moments[:, 1] / n
    mu20 = s1.moments[:, 2] / n - rbar * rbar + 1.0 / 12.0
    mu02 = s1.moments[:, 3] / n - cbar * cbar + 1.0 / 12.0
    mu11 = s1.moments[:, 4] / n - rbar * cbar
    common = torch.sqrt(torch.clamp((mu20 - mu02) ** 2 + 4 * mu11 * mu11,
                                    min=0.0))
    lam2 = torch.clamp((mu20 + mu02 - common) / 2.0, min=0.0)
    minor = 4.0 * torch.sqrt(lam2)
    keep = keep & (minor >= cfg["minor_axis_min"]) \
        & (minor <= cfg["minor_axis_max"]) & (s1.counts > 0)
    keep[0] = False
    keep = keep & (counts_e > 0)
    final = torch.cumsum(keep.to(torch.int32), dim=0, dtype=torch.int32)
    n_cells = int(final[-1])
    remap = torch.where(keep, torch.clamp(final, max=max_cells - 1),
                        torch.zeros_like(final))
    labels = segstats.label_lookup(eroded, remap, out_dtype=torch.int32)
    means = p.round(s1.sums / torch.clamp(counts_e, min=1.0)[:, None])
    return spectra_and_calls(labels, n_cells, remap, keep, means, clf, p,
                             max_cells)
