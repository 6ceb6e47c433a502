"""Plain reference of ``ms7b-fov2000``: the 7-bit LP-CV step from raw
per-laser planes to per-cell barcode calls, in plain torch on any device
(the semantics of hiprfish_tpu_torch's ``pipeline/fused.fov_step``, built
from the frozen copies in ``benchmark/plainref``; it imports nothing of
the port).

FFT registration -> NL-means -> LP-CV -> KMeans -> opening + fill holes
-> CCL + rank -> seed size filter -> watershed -> per-cell stats -> size
and border filter, relabel -> mean spectra -> check heads and kNN vote.
"""

from __future__ import annotations

import torch

from plainref import denoise as dn
from plainref import kmeans as km
from plainref import labeling as lab
from plainref import line_profile as lp
from plainref import morphology as morph
from plainref import register as reg
from plainref import segstats
from plainref import watershed as ws
from plainref.cells import spectra_and_calls
from plainref.precision import Precision


def _crop_fn(h, w, c):
    if c and h > c and w > c:
        r0, c0 = (h - c) // 2, (w - c) // 2
        return lambda im: im[r0:r0 + c, c0:c0 + c]
    return lambda im: im


def segment(stack, cfg: dict, max_cells: int, p: Precision):
    """(labels (H, W) int32 before the cell filter, registered cube)."""
    projections = [p.round(torch.sum(img, dim=2)) for img in stack]
    h, w = projections[0].shape
    crop = _crop_fn(h, w, cfg["register_crop"])
    cref = crop(projections[0])
    reg_dt = getattr(torch, cfg["registered_dtype"])
    parts = [stack[0].to(reg_dt)]
    fov_sum = projections[0]
    for i in range(1, len(stack)):
        s = reg.register_translation(cref, crop(projections[i]))
        if cfg["clamp_shift"]:
            s = reg.clamp_shift(s, cfg["max_shift"])
        parts.append(reg.apply_shift_2d(stack[i].to(reg_dt), s)[0])
        fov_sum = p.round(fov_sum + reg.apply_shift_2d(projections[i], s)[0])
    registered = torch.cat(parts, dim=2)
    sum_norm = p.round(fov_sum / torch.clamp(torch.max(fov_sum), min=1e-12))
    den = p.round(dn.denoise_nl_means(sum_norm, cfg["nlm_h"],
                                      cfg["nlm_patch_size"],
                                      cfg["nlm_patch_distance"]))
    enhanced = p.round(lp.lp_cv_enhance_2d(den, cfg["patch_size"],
                                           cfg["phi_range"]))
    bkg = km.brightest_cluster_mask(den, 2, cfg["kmeans_iters"])
    fg = km.brightest_cluster_mask(enhanced, 2, cfg["kmeans_iters"]) & bkg
    seed_mask = morph.binary_fill_holes(morph.binary_opening(fg), 1, 64)
    markers0 = lab.label(seed_mask, 2, cfg["ccl_max_iters"], cfg["scan_cap"])
    markers_seq, _ = segstats.rank_labels(markers0, 2, cfg["ccl_max_iters"],
                                          cfg["scan_cap"])
    pre = 2 * max_cells
    markers_seq = torch.clamp(markers_seq, max=pre - 1)
    st = segstats.label_stats(markers_seq, None, pre)
    ids = torch.arange(pre, dtype=torch.float32, device=markers_seq.device)
    keep_tbl = torch.where(st.counts >= cfg["lp_seed_min_size"], ids,
                           torch.zeros_like(ids))
    keep_tbl[0] = 0.0
    markers = segstats.label_lookup(markers_seq, keep_tbl,
                                    out_dtype=torch.int32) \
        * bkg.to(torch.int32)
    seg = ws.watershed(-(enhanced * bkg), markers, fg & bkg, 1,
                       cfg["watershed_max_iters"])
    return seg, registered


def run(stack, clf, cfg: dict, max_cells: int, p: Precision) -> dict:
    """Labels, cell count, mean spectra and calls of one FOV."""
    seg0, registered = segment(stack, cfg, max_cells, p)
    pre = 2 * max_cells
    stats = segstats.label_stats(seg0, registered, pre)
    keep = (stats.counts >= cfg["lp_cell_min_size"]) \
        & (stats.border_hits == 0)
    keep[0] = False
    final = torch.cumsum(keep.to(torch.int32), dim=0, dtype=torch.int32)
    n_cells = int(final[-1])
    remap = torch.where(keep, torch.clamp(final, max=max_cells - 1),
                        torch.zeros_like(final))
    labels = segstats.label_lookup(seg0, remap, out_dtype=torch.int32)
    means = p.round(stats.sums / torch.clamp(stats.counts, min=1.0)[:, None])
    return spectra_and_calls(labels, n_cells, remap, keep, means, clf, p,
                             max_cells)

