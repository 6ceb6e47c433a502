"""The 2D host engines (torch port of hiprfish_tpu/pipeline/segment2d.py).

``segment_ecoli`` is the E. coli engine with the reference's exact
per-round erosion semantics: register on per-laser max projections ->
log-sum -> KMeans foreground and interior -> fill small holes + opening +
remove_small(50) -> iterative erosion seeding -> watershed -> size and
border filters -> minor-axis gate with per-cell double erosion ->
sequential labels. The erosion loop reads one boolean back to the host
per round.

``segment_lpcv`` is the LP-CV engine: register on full-frame sum
projections (unclamped) -> channel sum -> max-normalise -> NL-means (kernel
B1 on the card) -> LP-CV (kernel B2) -> two KMeans masks -> opening,
small-object removal, fill holes -> CCL and relabel -> watershed. The
multispecies variant floods the enhanced image and filters the cells by
size and border. The biofilm variant registers on the log projections,
clusters the background on log10 of the denoised image, floods the
denoised image, keeps every cell, floods the channel sum over the whole
background for the adjacency segmentation and marks the epithelial area
(``_epithelial_area``).

Both run eagerly on the device of their inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.ops import denoise as dn
from hiprfish_tpu_torch.ops import fp
from hiprfish_tpu_torch.ops import kmeans as km
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.ops import line_profile as lp
from hiprfish_tpu_torch.ops import morphology as morph
from hiprfish_tpu_torch.ops import regionprops as rp
from hiprfish_tpu_torch.ops import register as reg
from hiprfish_tpu_torch.ops import watershed as ws


class Segmentation2D(NamedTuple):
    """Result of a 2D segmentation."""

    segmentation: torch.Tensor   # (H, W) int32, sequential labels 1..n
    n_cells: torch.Tensor        # scalar int32
    registered: torch.Tensor     # (H, W, C) registered (uncorrected) image
    fov_sum: torch.Tensor        # (H, W) registered channel sum
    enhanced: torch.Tensor       # (H, W) surface used for flooding
    adjacency: torch.Tensor      # (H, W) int32 adjacency segmentation (or 0s)
    epithelial: torch.Tensor     # (H, W) bool epithelial area (or False)


def _register_stack(image_stack, projections, max_shift, clamp,
                    log_domain=False):
    """Register per-laser images to laser 0 on their full-frame projections
    (on log(p + 1e-8) with ``log_domain``) and concatenate the channels.
    Returns (registered (H, W, C), overlap mask (H, W))."""
    if log_domain:
        projections = [torch.log(p + 1e-8) for p in projections]
    ref = projections[0]
    parts = [image_stack[0]]
    overlap = torch.ones(ref.shape, dtype=torch.bool, device=ref.device)
    for i in range(1, len(image_stack)):
        s = reg.register_translation(ref, projections[i])
        if clamp:
            s = reg.clamp_shift(s, max_shift)
        shifted, mask = reg.apply_shift_2d(image_stack[i], s)
        parts.append(shifted)
        overlap = overlap & mask
    return torch.cat(parts, dim=2), overlap


def _erode_labels_twice(labels: torch.Tensor) -> torch.Tensor:
    """Per-region double erosion of a label image: a pixel survives a pass
    iff its whole cross neighbourhood in the previous pass's labels carries
    its label (out-of-image counts as the same), as the reference erodes
    every cell against its own complement."""
    out = labels
    for _ in range(2):
        cur = out
        for off in morph._cross_shifts(labels.ndim):
            nb = lab.shifted(cur, off, -1)
            same = (nb == cur) | (nb == -1)
            out = torch.where(same, out, torch.zeros_like(out))
        out = torch.where(cur > 0, out, torch.zeros_like(out))
    return out


def _component_small_mask(mask: torch.Tensor, threshold: int):
    """(small_components, component_labels) of a boolean mask: the pixels
    of 8-connected components with fewer than ``threshold`` pixels."""
    lbl = lab.label(mask, 2)
    flat, counts = lab._id_counts(lbl)
    small = mask & (counts[flat] < threshold).reshape(mask.shape)
    return small, lbl


def erosion_seed_markers(cell_sm: torch.Tensor,
                         cfg: SegmentationConfig) -> torch.Tensor:
    """Iterative erosion seeding: components below seed_area_max become
    watershed seeds, the rest are eroded, cleared of 4-connected fragments
    below seed_min_size, and re-examined until the mask is empty or
    max_erosion_iters rounds have run. The 4-connected removal deletes the
    diagonal bridges between the lobes of a touching pair, so the lobes
    seed separately. Returns sequential int32 markers."""
    mask = cell_sm
    seeds = torch.zeros_like(cell_sm)
    for _ in range(cfg.max_erosion_iters):
        if not bool(torch.any(mask)):  # host sync
            break
        small, _ = _component_small_mask(mask, cfg.seed_area_max)
        seeds = seeds | small
        eroded = morph.binary_erosion(mask & ~small)
        mask = lab.remove_small_objects(eroded, cfg.seed_min_size, 1)
    # the final filter removes whole 8-connected seed components
    seed_mask = lab.remove_small_objects(seeds, cfg.seed_min_size, 2)
    markers, _ = lab.relabel_sequential(
        lab.label(seed_mask, 2, cfg.ccl_max_iters))
    return markers


def segment_ecoli(image_stack, cfg: SegmentationConfig = SegmentationConfig(),
                  max_cells: int = 4096) -> Segmentation2D:
    """Erosion-seeded watershed segmentation of a multi-laser FOV.

    image_stack: sequence of per-laser (H, W, C_l) float32 tensors on one
    device. The registered cube stays float32."""
    image_stack = tuple(torch.as_tensor(a) for a in image_stack)
    projections = [torch.amax(img, dim=2) for img in image_stack]
    registered, overlap = _register_stack(image_stack, projections,
                                          cfg.max_shift, cfg.clamp_shift)
    registered = registered * overlap[:, :, None]
    fov_sum = torch.sum(registered, dim=2)
    image_cn = torch.log(fov_sum + 1e-2)

    fg, interior = km.brightest_cluster_masks(image_cn, (2, 3),
                                              cfg.kmeans_iters)
    interior = morph.remove_small_holes(interior, 64)
    interior = morph.binary_opening(interior)
    cell_sm = lab.remove_small_objects(interior, 50, 1)

    markers = erosion_seed_markers(cell_sm, cfg)

    seg = ws.watershed(-image_cn, markers, fg, 1, cfg.watershed_max_iters)
    seg = lab.remove_small_labels(seg, cfg.cell_min_size)
    seg = lab.clear_border(seg)
    seg, _ = lab.relabel_sequential(seg)

    props = rp.shape_props_2d(seg, max_cells)
    minor = props["minor_axis_length"]
    keep = ((minor >= cfg.minor_axis_min) & (minor <= cfg.minor_axis_max)
            & (props["area"] > 0))
    keep[0] = False
    eroded = _erode_labels_twice(seg)
    kept = torch.where(keep[torch.clamp(eroded, 0, max_cells - 1).long()],
                       eroded, torch.zeros_like(eroded))
    seg_final, n_cells = lab.relabel_sequential(kept)

    zero_i = torch.zeros_like(seg_final)
    return Segmentation2D(
        segmentation=seg_final,
        n_cells=n_cells,
        registered=registered,
        fov_sum=fov_sum,
        enhanced=image_cn,
        adjacency=zero_i,
        epithelial=zero_i.to(torch.bool),
    )


def segment_lpcv(image_stack, calibration=None,
                 cfg: SegmentationConfig = SegmentationConfig(),
                 max_cells: int = 4096,
                 variant: str = "multispecies") -> Segmentation2D:
    """LP-CV enhanced watershed segmentation of a multi-laser FOV.

    image_stack: sequence of per-laser (H, W, C_l) float32 tensors on one
    device; calibration: None or a tensor the registered cube is divided
    by. The shifts come from FFT correlation of the full-frame per-laser
    channel sums (their logs for the biofilm variant) and are not clamped;
    the cube stays float32."""
    biofilm = _is_biofilm(variant)
    image_stack = tuple(torch.as_tensor(a) for a in image_stack)
    projections = [fp.sum_in_order(img, 2) for img in image_stack]
    registered, _ = _register_stack(image_stack, projections, cfg.max_shift,
                                    clamp=False, log_domain=biofilm)
    if calibration is not None:
        registered = registered / torch.as_tensor(calibration,
                                                  device=registered.device)
    return segment_lpcv_from_registered(registered, cfg, max_cells, variant)


def segment_lpcv_from_registered(
        registered, cfg: SegmentationConfig = SegmentationConfig(),
        max_cells: int = 4096,
        variant: str = "multispecies") -> Segmentation2D:
    """LP-CV segmentation of an already-registered (H, W, C) image.
    ``max_cells`` does not bound the labels (the reference's neither); it
    bounds the measurement that follows."""
    biofilm = _is_biofilm(variant)
    registered = torch.as_tensor(registered)
    fov_sum = fp.sum_in_order(registered, 2)
    sum_norm = fov_sum / torch.clamp(torch.max(fov_sum), min=1e-12)
    denoised = dn.denoise_nl_means_auto(sum_norm, cfg.nlm_h,
                                        cfg.nlm_patch_size,
                                        cfg.nlm_patch_distance)
    enhanced = lp.lp_cv_enhance_2d(denoised, cfg.patch_size, cfg.phi_range)

    # log10 as the reference computes it: log(x) times 1/ln(10) in float32
    bkg_src = torch.log(denoised + 1e-8) * _INV_LN10 if biofilm else denoised
    bkg = km.brightest_cluster_mask(bkg_src, 2, cfg.kmeans_iters)
    # every seed and flood mask is cut to the intensity foreground anyway,
    # so intersect first: the same seeds, compact blobs for the floods
    fg = km.brightest_cluster_mask(enhanced, 2, cfg.kmeans_iters) & bkg
    # fill(core) & fill(fg) == fill(core) for core, a filtered opening of
    # fg, inside fg
    seed_mask = morph.binary_fill_holes(lab.remove_small_objects(
        morph.binary_opening(fg), cfg.lp_seed_min_size, 1))
    if biofilm:
        surface = -(denoised * bkg)
        seed_mask = lab.remove_small_objects(seed_mask & bkg,
                                             cfg.lp_seed_min_size, 1)
    else:
        surface = -(enhanced * bkg)

    markers_all, _ = lab.relabel_sequential(
        lab.label(seed_mask, 2, cfg.ccl_max_iters))
    markers = markers_all * bkg.to(torch.int32)
    seg = ws.watershed(surface, markers, fg & bkg, 1,
                       cfg.watershed_max_iters)
    if biofilm:
        seg, n_cells = lab.relabel_sequential(seg)
        adjacency, _ = lab.relabel_sequential(ws.watershed(
            -(fov_sum * bkg), markers, bkg, 1, cfg.watershed_max_iters))
        epithelial = _epithelial_area(bkg, fov_sum, cfg)
    else:
        seg, n_cells = lab.filter_and_relabel(seg, cfg.lp_cell_min_size)
        adjacency = torch.zeros_like(seg)
        epithelial = torch.zeros(seg.shape, dtype=torch.bool,
                                 device=seg.device)
    return Segmentation2D(
        segmentation=seg,
        n_cells=n_cells,
        registered=registered,
        fov_sum=fov_sum,
        enhanced=enhanced,
        adjacency=adjacency,
        epithelial=epithelial,
    )


# float32 1/ln(10), the factor of jnp.log10
_INV_LN10 = 0.4342944920063019


def _epithelial_area(bkg_mask: torch.Tensor, fov_sum: torch.Tensor,
                     cfg: SegmentationConfig) -> torch.Tensor:
    """The epithelial/debris area: the background's complement without
    4-connected objects below bkg_min_size, holes filled, closed with a
    disk; its largest 8-connected object, dilated by the disk, is the main
    background; the objects outside it seed a flood of -fov_sum over the
    whole image, and every pixel outside the largest basin is flagged.

    The flood has no mask and stops after watershed_max_iters rounds, as
    the reference's does: a pixel it has not reached by then keeps label
    0 and so counts as epithelial. argmax takes the first index on ties,
    so with no object at all every pixel has label 0 = argmax and none is
    flagged."""
    r = cfg.epithelial_disk_radius
    image_bkg = lab.remove_small_objects(~bkg_mask, cfg.bkg_min_size, 1)
    image_bkg = morph.binary_fill_holes(image_bkg)
    closed = morph.binary_closing_disk(image_bkg, r)
    objs = lab.label(closed, 2, cfg.ccl_max_iters)
    _, counts = lab._id_counts(objs)
    counts[0] = 0
    bkg_final = (objs == torch.argmax(counts)) & closed
    bkg_dil = morph.binary_dilation_disk(bkg_final, r)
    fg_objs, _ = lab.relabel_sequential(
        lab.label(~bkg_dil, 2, cfg.ccl_max_iters))
    flooded = ws.watershed(-fov_sum, fg_objs, None, 1,
                           cfg.watershed_max_iters)
    _, counts2 = lab._id_counts(flooded)
    counts2[0] = 0
    return flooded != torch.argmax(counts2)


def _is_biofilm(variant: str) -> bool:
    if variant not in ("multispecies", "biofilm"):
        raise ValueError(f"segment_lpcv: unknown variant {variant!r}")
    return variant == "biofilm"
