"""The 2D host engines (torch port of hiprfish_tpu/pipeline/segment2d.py).

``segment_ecoli`` is the E. coli engine with the reference's exact
per-round erosion semantics: register on per-laser max projections ->
log-sum -> KMeans foreground and interior -> fill small holes + opening +
remove_small(50) -> iterative erosion seeding -> watershed -> size and
border filters -> minor-axis gate with per-cell double erosion ->
sequential labels. The erosion loop reads one boolean back to the host
per round.

``segment_lpcv`` is the synthetic-community LP-CV engine: register on
full-frame sum projections (unclamped) -> channel sum -> max-normalise ->
NL-means (kernel B1 on the card) -> LP-CV (kernel B2) -> two KMeans masks
-> opening, small-object removal, fill holes -> CCL and relabel ->
watershed on the enhanced image -> size and border filter. Its biofilm
variant is not ported yet (ROADMAP §A.4).

Both run eagerly on the device of their inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.ops import denoise as dn
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
    adjacency: torch.Tensor      # (H, W) int32 adjacency segmentation (0s)
    epithelial: torch.Tensor     # (H, W) bool epithelial area (False)


def _register_stack(image_stack, projections, max_shift, clamp):
    """Register per-laser images to laser 0 on their full-frame projections
    and concatenate the channels. Returns (registered (H, W, C), overlap
    mask (H, W))."""
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
    channel sums and are not clamped; the cube stays float32."""
    _require_multispecies(variant)
    image_stack = tuple(torch.as_tensor(a) for a in image_stack)
    projections = [torch.sum(img, dim=2) for img in image_stack]
    registered, _ = _register_stack(image_stack, projections, cfg.max_shift,
                                    clamp=False)
    if calibration is not None:
        registered = registered / torch.as_tensor(calibration,
                                                  device=registered.device)
    return segment_lpcv_from_registered(registered, cfg, max_cells, variant)


def segment_lpcv_from_registered(
        registered, cfg: SegmentationConfig = SegmentationConfig(),
        max_cells: int = 4096,
        variant: str = "multispecies") -> Segmentation2D:
    """LP-CV segmentation of an already-registered (H, W, C) image.
    ``max_cells`` does not bound the multispecies labels (the reference's
    neither); it bounds the measurement that follows."""
    _require_multispecies(variant)
    registered = torch.as_tensor(registered)
    fov_sum = torch.sum(registered, dim=2)
    sum_norm = fov_sum / torch.clamp(torch.max(fov_sum), min=1e-12)
    denoised = dn.denoise_nl_means_auto(sum_norm, cfg.nlm_h,
                                        cfg.nlm_patch_size,
                                        cfg.nlm_patch_distance)
    enhanced = lp.lp_cv_enhance_2d(denoised, cfg.patch_size, cfg.phi_range)

    bkg = km.brightest_cluster_mask(denoised, 2, cfg.kmeans_iters)
    # every seed and flood mask is cut to the intensity foreground anyway,
    # so intersect first: the same seeds, compact blobs for the floods
    fg = km.brightest_cluster_mask(enhanced, 2, cfg.kmeans_iters) & bkg
    # fill(core) & fill(fg) == fill(core) for core, a filtered opening of
    # fg, inside fg
    seed_mask = morph.binary_fill_holes(lab.remove_small_objects(
        morph.binary_opening(fg), cfg.lp_seed_min_size, 1))

    markers_all, _ = lab.relabel_sequential(
        lab.label(seed_mask, 2, cfg.ccl_max_iters))
    markers = markers_all * bkg.to(torch.int32)
    seg = ws.watershed(-(enhanced * bkg), markers, fg & bkg, 1,
                       cfg.watershed_max_iters)
    seg, n_cells = lab.filter_and_relabel(seg, cfg.lp_cell_min_size)

    zero_i = torch.zeros_like(seg)
    return Segmentation2D(
        segmentation=seg,
        n_cells=n_cells,
        registered=registered,
        fov_sum=fov_sum,
        enhanced=enhanced,
        adjacency=zero_i,
        epithelial=zero_i.to(torch.bool),
    )


def _require_multispecies(variant: str) -> None:
    if variant == "biofilm":
        raise NotImplementedError(
            "segment_lpcv: the biofilm variant (log-domain registration, "
            "adjacency flood, epithelial area) is not ported yet "
            "(ROADMAP §A.4)")
    if variant != "multispecies":
        raise ValueError(f"segment_lpcv: unknown variant {variant!r}")
