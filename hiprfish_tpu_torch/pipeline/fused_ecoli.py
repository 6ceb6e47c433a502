"""The 10-bit E. coli FOV step in PyTorch (port of
hiprfish_tpu/pipeline/fused_ecoli.py).

``segment_ecoli_device`` has the host engine's semantics
(pipeline/segment2d.py::segment_ecoli) with the erosion seeding as an
erosion-depth histogram: one CCL + rank of the interior, a depth transform
of 39 cross erosions, one per-label [count, depth histogram] pass (kernel
B3) and one table lookup (kernel B4) give every component its seed depth.
The size, border and minor-axis gates and the spectral measurement of the
double-eroded cells are one more B3 pass, with moments and the eroded
mask, over the watershed labels. ``fov_step_ecoli`` adds the row-max
normalisation, the violet-derivative features and the 6-head classifier.

Each ``fov_step_ecoli`` call is the span ``step`` over the stage spans
``register``, ``kmeans``, ``small_holes``, ``morphology``, ``markers``,
``watershed``, ``stats`` and ``classify`` (``utils.logging.span``: on
while a torch profiler records).
"""

from __future__ import annotations

import torch

from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.ops import kmeans as km
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.ops import morphology as morph
from hiprfish_tpu_torch.ops import register as reg
from hiprfish_tpu_torch.ops import segstats
from hiprfish_tpu_torch.ops import watershed as ws
from hiprfish_tpu_torch.pipeline import fused
from hiprfish_tpu_torch.pipeline.segment2d import _erode_labels_twice
from hiprfish_tpu_torch.utils.logging import span


def _register(stack, cfg: SegmentationConfig):
    """(registered cube in cfg.registered_dtype, log-sum image): shifts from
    FFT correlation of the per-laser channel MAX projections of the centred
    register_crop; the KMeans input comes from f32 per-laser channel sums
    rolled by the same shifts, masked by the overlap."""
    h, w = stack[0].shape[0], stack[0].shape[1]
    c = cfg.register_crop
    if c and h > c and w > c:
        r0, c0 = (h - c) // 2, (w - c) // 2
        _crop3 = lambda im: im[r0:r0 + c, c0:c0 + c]  # noqa: E731
    else:
        _crop3 = lambda im: im  # noqa: E731
    projections = [torch.amax(_crop3(img), dim=2) for img in stack]
    cref = projections[0]
    reg_dt = getattr(torch, cfg.registered_dtype)
    sums2d = [torch.sum(img, dim=2) for img in stack]
    parts = [stack[0].to(reg_dt)]
    fov_sum = sums2d[0]
    overlap = torch.ones((h, w), dtype=torch.bool, device=cref.device)
    for i in range(1, len(stack)):
        s = reg.register_translation(cref, projections[i])
        if cfg.clamp_shift:
            s = reg.clamp_shift(s, cfg.max_shift)
        shifted, mask = reg.apply_shift_2d(stack[i].to(reg_dt), s)
        parts.append(shifted)
        fov_sum = fov_sum + reg.apply_shift_2d(sums2d[i], s)[0]
        overlap = overlap & mask
    registered = torch.cat(parts, dim=2) * overlap[:, :, None].to(reg_dt)
    fov_sum = fov_sum * overlap
    return registered, torch.log(fov_sum + 1e-2)


def _seed_markers(interior, cfg: SegmentationConfig, pre_segments: int):
    """Sequential watershed markers of the cell interior by erosion depth.

    Pixel p survives k erosions iff depth(p) > k, so a component's area
    after k erosions is read from its (component, depth) histogram; it
    seeds at the first k where that area drops below seed_area_max, with
    the pixels {depth > k}. Components below 50 px or with seeds below
    seed_min_size get a depth bound no pixel exceeds. A 4-connected
    sub-seed_min_size removal then deletes diagonal bridge fragments, so
    the lobes of a touching pair label as separate markers."""
    cap = cfg.scan_cap
    comp0, _ = segstats.rank_labels(
        lab.label(interior, 2, cfg.ccl_max_iters, cap), 2,
        cfg.ccl_max_iters, cap)
    comp0 = torch.clamp(comp0, max=pre_segments - 1)

    kmax = cfg.max_erosion_iters
    m = interior
    depth = interior.to(torch.int32)
    for _ in range(kmax - 1):
        m = morph.binary_erosion(m) & interior
        depth = depth + m
    depth_c = torch.clamp(depth, 0, kmax)
    dstats = segstats.label_stats(comp0, None, pre_segments, aux=depth_c,
                                  aux_classes=kmax + 1)
    hist = dstats.aux_hist                                   # (S, kmax + 1)
    # area_k[s, k] = #pixels of s with depth > k
    area_k = torch.flip(torch.cumsum(torch.flip(hist, [1]), dim=1),
                        [1])[:, 1:]
    small = area_k < cfg.seed_area_max
    # the first k with a small area; 0 when there is none (jnp.argmax)
    k_seed = torch.argmax(small.to(torch.int32), dim=1)
    seed_area = torch.gather(area_k, 1, k_seed[:, None])[:, 0]
    ids = torch.arange(pre_segments, device=interior.device)
    valid_seed = (seed_area >= cfg.seed_min_size) \
        & (dstats.counts >= 50) & (ids > 0)
    ktbl = torch.where(valid_seed, k_seed,
                       torch.full_like(k_seed, kmax + 1)).to(torch.float32)
    k_pix = segstats.label_lookup(comp0, ktbl)
    seed_mask = (depth.to(torch.float32) > k_pix) & (comp0 > 0)

    lbl4, _ = segstats.rank_labels(
        lab.label(seed_mask, 1, cfg.ccl_max_iters, cap), 1,
        cfg.ccl_max_iters, cap)
    lbl4 = torch.clamp(lbl4, max=pre_segments - 1)
    st4 = segstats.label_stats(lbl4, None, pre_segments)
    keep4 = (st4.counts >= cfg.seed_min_size).to(torch.float32)
    keep4[0] = 0.0
    seed_mask = seed_mask & (segstats.label_lookup(lbl4, keep4) > 0.5)
    markers, _ = segstats.rank_labels(
        lab.label(seed_mask, 2, cfg.ccl_max_iters, cap), 2,
        cfg.ccl_max_iters, cap)
    return torch.clamp(markers, max=pre_segments - 1)


def segment_ecoli_device(stack, cfg: SegmentationConfig = SegmentationConfig(),
                         max_cells: int = 4096):
    """(seg, n_cells, registered, avgint) of a tuple of per-laser (H, W,
    C_l) float32 tensors on one device. ``avgint`` (max_cells, C) holds the
    mean spectrum of each cell's double-eroded interior, row 0 zero."""
    with span("register"):
        registered, image_cn = _register(stack, cfg)
    with span("kmeans"):
        fg, interior = km.brightest_cluster_masks(image_cn, (2, 3),
                                                  cfg.kmeans_iters)
    with span("small_holes"):
        interior = segstats.remove_small_holes_fast(
            interior, 64, flood_max_run=64, exact_fallback=False)
    with span("morphology"):
        interior = morph.binary_opening(interior)
    pre_segments = 2 * max_cells
    with span("markers"):
        markers = _seed_markers(interior, cfg, pre_segments)
    with span("watershed"):
        seg_ws = ws.watershed(-image_cn, markers, fg, 1,
                              cfg.watershed_max_iters)
    with span("stats"):
        return _gate_and_measure(seg_ws, registered, cfg, max_cells,
                                 pre_segments)


def _gate_and_measure(seg_ws, registered, cfg: SegmentationConfig,
                      max_cells: int, pre_segments: int):
    """segment_ecoli_device's last stage: (seg, n_cells, registered,
    avgint) from the watershed labels."""
    # size/border filter, shape gate and the eroded cells' spectra in one
    # pass: the double-eroded image keeps its parent's ids, so its sums and
    # counts are masked columns of the pass over seg_ws
    eroded = _erode_labels_twice(seg_ws)
    s1 = segstats.label_stats(seg_ws, registered, pre_segments,
                              moments=True,
                              image_mask=(eroded > 0).to(torch.float32))
    counts_e = s1.mask_counts
    keep = (s1.counts >= cfg.cell_min_size) & (s1.border_hits == 0)
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
    keep = keep & (minor >= cfg.minor_axis_min) \
        & (minor <= cfg.minor_axis_max) & (s1.counts > 0)
    keep[0] = False
    # cells the double erosion erased vanish, as in the host engine
    keep = keep & (counts_e > 0)
    final = torch.cumsum(keep.to(torch.int32), dim=0, dtype=torch.int32)
    n_cells = final[-1]
    remap = torch.where(keep, torch.clamp(final, max=max_cells - 1),
                        torch.zeros_like(final))
    seg_final = segstats.label_lookup(eroded, remap, out_dtype=torch.int32)
    means = s1.sums / torch.clamp(counts_e, min=1.0)[:, None]
    avgint = torch.zeros((max_cells, means.shape[1]), dtype=torch.float32,
                         device=means.device)
    fused._scatter_last(avgint, remap, keep, means)
    return seg_final, n_cells, registered, avgint


def violet_features(avgint_norm: torch.Tensor, blocks) -> torch.Tensor:
    """The feature base of the 10-bit classifier: the normalised spectra
    and the derivative (np.diff) of the first (405 nm) block."""
    lo, hi = blocks[0]
    return torch.cat(
        [avgint_norm, torch.diff(avgint_norm[:, lo:hi], dim=1)], dim=1)


def fov_step_ecoli(stack, clf_arrays, cfg: SegmentationConfig,
                   max_cells: int, clf_static,
                   classify_cap: int = 2048) -> fused.FovResult:
    """The 10-bit forward step: raw per-laser planes -> barcode calls,
    through the 132-d feature build ([95 channels, the violet derivative of
    the first block, 6 check bits]) and the gated kNN vote.

    stack: tuple of per-laser (H, W, C_l) float32 tensors on one device.
    clf_arrays, clf_static: from fused.classifier_from_numpy."""
    # the kNN distances are float32 GEMMs: no TF32 anywhere in the step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = clf_static
    with span("step"):
        seg, n_cells, _, avgint = segment_ecoli_device(stack, cfg, max_cells)
        with span("classify"):
            avgint_norm = avgint / torch.clamp(
                torch.max(avgint, dim=1, keepdim=True).values, min=1e-12)
            code_idx, max_prob = fused.classify_capped(
                violet_features(avgint_norm, blocks), n_cells, classify_cap,
                clf_arrays["check_heads"],
                check_blocks,
                clf_arrays.get("scaler_mean"),
                clf_arrays.get("scaler_scale"),
                clf_arrays["train_features"],
                clf_arrays["train_labels"],
                n_classes, blocks, check_slice, n_channels, k, temperature,
            )
        slots = torch.arange(max_cells, device=seg.device)
        valid = (slots <= n_cells) & (slots > 0)
    return fused.FovResult(seg, n_cells, avgint, avgint_norm, code_idx,
                           max_prob, valid)
