"""Plain reference of ``bio7b-vol2020``: one stitched 7-bit biofilm volume
from its summed microscope tiles and channels-major slabs to per-cell
barcode calls, in plain torch on any device (the semantics that
hiprfish_tpu_torch's ``segment3d.volume_step`` promises, built from the
frozen copies in ``benchmark/plainref``; it imports nothing of the port).

3D phase-correlation stitch -> normalise -> log10 KMeans background ->
3D LP-CV -> KMeans foreground and interior thresholds -> seed mask
(threshold, opening, fill holes) -> CCL + rank of the seeds -> seed size
filter -> watershed -> sequential relabel -> per-cell channel sums over
z-slabs -> row-max normalisation -> check heads and kNN vote.

Departures from the program, each on purpose:

* the volume is segmented as one: global thresholds and seeds as the
  program's, but whole-volume CCL, rank, seed filter and watershed in
  place of its margin-tiled sweep, boundary union-find and remap, so that
  a fault in any of those shows as moved pixels (``px_gap``,
  ``cells_changed``);
* cells are numbered by the rank of their seed's lowest (X, Z, Y) linear
  index among the kept seeds, not by the program's tile order (the
  comparison pairs cells by their voxels, not their ids);
* the 3D LP-CV runs in x-slabs with the stencil's halo, and the per-cell
  sums in z-slabs of the stack's own depth, blocks that change no result;
* the seed floods' scans are capped at 32 steps (the program's
  ``scan_cap``): a cap changes the number of rounds, never the labels;
* storage as the configuration states it: the 3D LP-CV's samples are the
  normalised volume rounded to bfloat16, and the channel slabs arrive in
  bfloat16; every other value is float32 (``Precision`` rounds each
  stage's float result in the control).
"""

from __future__ import annotations

import torch

from plainref import kmeans as km
from plainref import labeling as lab
from plainref import line_profile3d as lp3d
from plainref import morphology as morph
from plainref import register3d
from plainref import segstats
from plainref import watershed as ws
from plainref.classify import classify
from plainref.precision import Precision
from plainref.stats_cm import stats_cm

# the seed floods' scan cap
SCAN = 32
# the stitch's blank border
PAD = 10


def segment(vol: torch.Tensor, cfg: dict, max_cells: int, p: Precision):
    """(labels (X, Z, Y) int32 with cells 1..n, n) of an (X, Y, Z) channel
    sum."""
    vol = vol.permute(0, 2, 1).contiguous()
    vol_norm = p.round(vol / torch.clamp(torch.max(vol), min=1e-12))
    del vol
    logv = p.round(torch.log10(vol_norm + 1e-8))
    bkg = km.brightest_cluster_mask(logv, 2, cfg["kmeans_iters"])
    del logv
    enhanced = p.round(lp3d.lp_cv_enhance_3d(
        vol_norm, cfg["patch_size"], cfg["theta_range"], cfg["phi_range"],
        bf16=True))
    del vol_norm
    c2, c3 = km.kmeans1d_centers_multi(enhanced, (2, 3), cfg["kmeans_iters"])
    thr_fg = (c2[-1] + c2[-2]) / 2.0
    thr_int = (c3[-1] + c3[-2]) / 2.0
    pos = enhanced > 0
    fg = (enhanced >= thr_fg) & pos
    interior = (enhanced >= torch.maximum(thr_fg, thr_int)) & pos
    seeds = morph.binary_fill_holes(morph.binary_opening(interior), 1, 128)
    del interior, pos
    iters = cfg["ccl_max_iters"]
    markers, n = segstats.rank_labels(lab.label(seeds & bkg, 3, iters, SCAN),
                                      3, iters, SCAN)
    n = int(n)
    counts = torch.bincount(markers.reshape(-1), minlength=n + 1)
    keep = counts >= cfg["lp_seed_min_size"]
    keep[0] = False
    markers = torch.where(keep[markers.to(torch.int64)], markers,
                          torch.zeros_like(markers))
    seg = ws.watershed(-(enhanced * bkg), markers, seeds | (fg & bkg), 1,
                       cfg["watershed_max_iters"])
    del enhanced, markers, fg
    present = torch.bincount(seg.reshape(-1), minlength=n + 1) > 0
    present[0] = False
    rank = torch.clamp(torch.cumsum(present.to(torch.int32), 0), max=max_cells - 1)
    labels = torch.where(present, rank, torch.zeros_like(rank)).to(
        torch.int32)[seg.to(torch.int64)]
    return labels, min(int(present.sum()), max_cells - 1)


def run(stack, clf, cfg: dict, max_cells: int, p: Precision) -> dict:
    """Labels (X, Z, Y), cell count, mean spectra (row i cell i, row 0
    zero) and calls of cells 1..n of one volume (a
    ``volume7b_scenes.VolumeStack``)."""
    vol = p.round(register3d.stitch_tiles(stack.tiles, stack.grid,
                                          stack.overlap, PAD))
    labels, n = segment(vol, cfg, max_cells, p)
    del vol
    z, zc = labels.shape[1], stack.slab_planes
    acc = None
    for z0 in range(0, z, zc):
        slab = stack.slabs(z0, min(zc, z - z0))
        part = stats_cm(labels[:, z0:z0 + slab.shape[1]].permute(1, 0, 2)
                        .contiguous(), slab, max_cells)
        acc = part if acc is None else acc + part
    avgint = p.round(acc[:, 1:] / torch.clamp(acc[:, :1], min=1.0))
    avgint[0] = 0.0
    norm = p.round(avgint / torch.clamp(
        torch.max(avgint, dim=1, keepdim=True).values, min=1e-12))
    code, prob, scores = classify(norm[1:n + 1], clf, p)
    return {"labels": labels, "n_cells": n, "avgint": avgint, "code": code,
            "prob": prob, "scores": scores}
