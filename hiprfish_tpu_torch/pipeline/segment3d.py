"""The 3D biofilm volume path in PyTorch (port of the tiled engine of
hiprfish_tpu/pipeline/segment3d.py).

stitch_tiles_device -> segment_3d_tiled (3D LP-CV, kernel B6 -> global
KMeans thresholds -> global seed mask -> margin-tiled CCL + rank + seed
size filter (B3, B4) + watershed -> host union-find over the tile
boundaries -> remap (B4)) -> measure_volume_streamed / make_fused_measure
(per-cell spectra streamed over z-slabs, B5 for channels-major slabs, B3
otherwise). Classification is pipeline/fused.classify_device.

Everything runs eagerly on the device of its inputs. From the moment
segment_3d_tiled has the summed volume it works in the canonical (X, Z, Y)
layout, as the reference does: component ids (the minimum linear index),
their ranks, the KMeans histogram's strided subsample and the union-find's
smaller root all follow linear order in that layout, so the cell numbering
and thresholds are the reference's.

register_volume_stack aligns per-laser (X, Y, Z, C_l) z-stacks on their
log channel sums; the z-slice front end (segment_zstack_slice,
measure_biofilm_images_2d_from_zstack_cli) runs the 2D biofilm engine on
single planes of the registered stack (kernels B1 and B2 on the card).

Where the reference branched inside a compiled program or spilled a
fixed-size device buffer, the port reads a small result back to the host:
the stitch shifts once, the boundary pair sets (torch.unique per boundary
is exact, so the reference's pair cap and its full-plane fallback are not
needed) and the per-tile presence bitmaps.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.io import images as iio
from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.models import classifier
from hiprfish_tpu_torch.ops import fp
from hiprfish_tpu_torch.ops import kmeans as km
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.ops import line_profile as lp
from hiprfish_tpu_torch.ops import morphology as morph
from hiprfish_tpu_torch.ops import register as reg
from hiprfish_tpu_torch.ops import regionprops as rp
from hiprfish_tpu_torch.ops import segstats
from hiprfish_tpu_torch.ops import watershed as ws
from hiprfish_tpu_torch.pipeline import biofilm as bf
from hiprfish_tpu_torch.pipeline import measure as meas
from hiprfish_tpu_torch.pipeline import segment2d
from hiprfish_tpu_torch.pipeline.classify import SHAPE_COLUMNS


# ---------------------------------------------------------------------------
# Stitching
# ---------------------------------------------------------------------------


def register_volume_stack(volume_stack):
    """Register per-laser (X, Y, Z, C_l) volumes to laser 0 by 3D phase
    correlation of the logs of their channel sums, each shift read to the
    host once, and concatenate the channels: (X, Y, Z, C), zeros where a
    shifted laser has no data."""
    vols = [torch.as_tensor(v) for v in volume_stack]
    sums = [torch.log(fp.sum_in_order(v, 3) + 1e-8) for v in vols]
    parts = [vols[0]]
    for i in range(1, len(vols)):
        shift = reg.register_translation_3d(sums[0], sums[i])
        parts.append(reg.apply_shift_3d(vols[i], shift)[0])
    return torch.cat(parts, dim=3)


def stitch_tiles_device(tile_volumes, grid, overlap: int, out_shape,
                        pad: int = 10, strip: int | None = None,
                        tile_masks=None) -> torch.Tensor:
    """Microscope-tile stitching: chain phase-correlation registration of
    neighbouring tiles on their ``strip``-deep overlap faces, then
    overlap-count-blended accumulation.

    tile_volumes: list of (ty, tx, tz) tensors in row-major grid order;
    grid (gy, gx); overlap: nominal overlap along y and x; out_shape
    (Y, X, Z) before padding; strip defaults to ``overlap``; tile_masks:
    optional per-tile validity masks (invalid voxels add neither intensity
    nor count). The shifts are read to the host once. Returns the
    (Y + 2 pad, X + 2 pad, Z + 2 pad) blended volume."""
    if strip is None:
        strip = overlap
    gy, gx = grid
    tiles = [t.to(torch.float32) for t in tile_volumes]
    ty, tx, tz = tiles[0].shape
    dev = tiles[0].device
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    found = []
    for i in range(gy):
        for j in range(gx):
            if i == 0 and j == 0:
                found.append(zero)
            elif j == 0:
                found.append(reg.register_translation_3d(
                    tiles[(i - 1) * gx][-strip:], tiles[i * gx][:strip]))
            else:
                found.append(reg.register_translation_3d(
                    tiles[i * gx + j - 1][:, -strip:],
                    tiles[i * gx + j][:, :strip]))
    sh = torch.stack(found).to(torch.int32).cpu().numpy().reshape(gy, gx, 3)
    shape = (out_shape[0] + 2 * pad, out_shape[1] + 2 * pad,
             out_shape[2] + 2 * pad)
    full = torch.zeros(shape, dtype=torch.float32, device=dev)
    count = torch.zeros_like(full)
    step_y, step_x = ty - overlap, tx - overlap
    for i in range(gy):
        for j in range(gx):
            sy = int(i * step_y + pad + sh[1:i + 1, 0, 0].sum()
                     + sh[i, 1:j + 1, 0].sum())
            sx = int(j * step_x + pad + sh[i, :j + 1, 1].sum())
            sz = int(pad + sh[i, :j + 1, 2].sum())
            win = (slice(sy, sy + ty), slice(sx, sx + tx), slice(sz, sz + tz))
            if tile_masks is None:
                full[win] += tiles[i * gx + j]
                count[win] += 1.0
            else:
                msk = torch.as_tensor(tile_masks[i * gx + j], device=dev) \
                    .to(torch.float32)
                full[win] += tiles[i * gx + j] * msk
                count[win] += msk
    return full / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# 3D LP-CV, thresholds, seeds
# ---------------------------------------------------------------------------


def lp_cv_enhance_3d_chunked(volume: torch.Tensor,
                             cfg: SegmentationConfig = SegmentationConfig(),
                             chunk_xy: int = 128, bf16: bool | None = None,
                             layout: str = "xyz") -> torch.Tensor:
    """Fused 3D LP-CV enhancement (kernel B6 on CUDA, the xy-chunked plain
    version on the CPU); ``bf16=None`` is bf16 on CUDA and f32 on the CPU,
    as the reference's backend default. ``layout="xzy"``: the volume
    arrives, and the result returns, in the canonical (X, Z, Y) layout."""
    return lp.lp_cv_enhance_3d(volume, cfg.patch_size, cfg.theta_range,
                               cfg.phi_range, chunk_xy, bf16, layout)


def _cluster_threshold(values: torch.Tensor, k: int,
                       iters: int) -> torch.Tensor:
    """Global KMeans boundary between the two brightest clusters (value >=
    midpoint is the brightest cluster's membership), from centres only."""
    centers = km.kmeans1d_centers(values, k, iters)
    return (centers[-1] + centers[-2]) / 2.0


def _global_seeds(enhanced: torch.Tensor, thr_seed,
                  max_run: int = 128) -> torch.Tensor:
    """Watershed seed mask of the whole (x, Z, Y) volume: threshold ->
    opening -> border-flood fill-holes."""
    interior = (enhanced.to(torch.float32) >= thr_seed) & (enhanced > 0)
    interior = morph.binary_opening(interior)
    return morph.binary_fill_holes(interior, 1, max_run)


# ---------------------------------------------------------------------------
# The margin-tiled sweep
# ---------------------------------------------------------------------------


def _tile_body(enh, bkg, seeds_mask, thr_fg, statics, shapes):
    """One (slab_x, Z, Y) slab: tile-local CCL + rank over the seed mask,
    seed size filter (B3 counts, B4 lookup), watershed, margin crop, the
    crop's id-presence bitmap, and the private labels on the plane pair
    that straddles the tile's right boundary."""
    seed_min, ccl_iters, ws_iters, tile_cap, scan_cap = statics
    tile_x, margin = shapes
    # the id floods' scan-doubling cap: seed components are cells (smaller
    # than the margin), so a cap only trades doubling passes for fixpoint
    # rounds and never changes the result
    cap = min(margin, scan_cap) if scan_cap else margin
    fg = (enh >= thr_fg) & (enh > 0)
    markers0, _ = segstats.rank_labels(
        lab.label(seeds_mask & bkg, 3, ccl_iters, cap), 3, ccl_iters, cap)
    markers0 = torch.clamp(markers0, max=tile_cap - 1)
    st = segstats.label_stats(markers0, None, tile_cap)
    ids = torch.arange(tile_cap, dtype=torch.float32, device=enh.device)
    keep_tbl = torch.where(st.counts >= seed_min, ids, torch.zeros_like(ids))
    keep_tbl[0] = 0.0
    markers = segstats.label_lookup(markers0, keep_tbl).to(torch.int32)
    seg = ws.watershed(-(enh * bkg), markers, seeds_mask | (fg & bkg), 1,
                       ws_iters)
    out = seg[margin:margin + tile_x]
    present = segstats.label_stats(out, None, tile_cap).counts > 0
    planes = seg[margin + tile_x - 1:margin + tile_x + 1]
    return out, present, planes


def _segment_one_tile_seeded(enh, bkg, seeds_mask, thr_fg, statics, shapes):
    """The tile body with the seed mask from _global_seeds."""
    return _tile_body(enh.to(torch.float32), bkg, seeds_mask, thr_fg,
                      statics, shapes)


def _segment_tile_at_seeded(enhanced_p, bkg_p, seeds_p, thr_fg, start: int,
                            statics, shapes):
    """Slab [start, start + tile_x + 2 margin) of the padded (x, Z, Y)
    volumes, segmented."""
    tile_x, margin = shapes
    sl = slice(start, start + tile_x + 2 * margin)
    return _segment_one_tile_seeded(enhanced_p[sl], bkg_p[sl], seeds_p[sl],
                                    thr_fg, statics, shapes)


def _tiled_segment_pass(boxes, thr_fg, statics, shapes,
                        log=lambda m: None):
    """Host loop over the tiles. ``boxes`` is [(enhanced_p, bkg_p,
    seeds_p)] in the (x, Z, Y) layout; it is emptied so the padded inputs
    free when the loop ends. Returns (list of (tile_x, Z, Y) label tiles,
    list of (tile_cap,) presence bitmaps, list of (2, Z, Y) boundary
    planes)."""
    tile_x, margin, n_tiles = shapes
    enhanced_p, bkg_p, seeds_p = boxes.pop()
    outs, presents, planes = [], [], []
    for t in range(n_tiles):
        o, p, pl = _segment_tile_at_seeded(enhanced_p, bkg_p, seeds_p,
                                           thr_fg, t * tile_x, statics,
                                           (tile_x, margin))
        outs.append(o)
        presents.append(p)
        planes.append(pl)
        log(f"tile {t + 1}/{n_tiles}")
    return outs, presents, planes


def _boundary_pair_codes(tiles, planes, tile_cap: int) -> list:
    """For each boundary t (tiles t | t+1): the sorted unique codes
    left_rank * tile_cap + right_rank over the voxels where tile t's
    private labeling joins the two adjacent x-planes
    (planes[t][0] == planes[t][1] > 0) and both cropped labelings are
    foreground, as int64 tensors on the tiles' device."""
    out = []
    for t in range(len(tiles) - 1):
        a, b = tiles[t][-1], tiles[t + 1][0]
        priv = planes[t]
        same = (priv[0] == priv[1]) & (priv[0] > 0) & (a > 0) & (b > 0)
        code = a[same].to(torch.int64) * tile_cap + b[same].to(torch.int64)
        out.append(torch.unique(code))
    return out


def _remap_tile(labels: torch.Tensor, full_table: torch.Tensor, t: int,
                tile_cap: int) -> torch.Tensor:
    """One tile's labels through its slice of the global remap table
    (kernel B4 on CUDA)."""
    tbl = full_table[t * tile_cap:(t + 1) * tile_cap]
    return segstats.label_lookup(labels, tbl).to(torch.int32)


def _edge_pad_x(vol: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Edge padding along axis 0 for any dtype."""
    return torch.cat([vol[:1].expand(before, *vol.shape[1:]), vol,
                      vol[-1:].expand(after, *vol.shape[1:])])


def segment_3d_tiled(vol_sum, cfg: SegmentationConfig = SegmentationConfig(),
                     max_cells: int = 16384, tile_x: int = 360,
                     margin: int = 64, tile_cap: int = 8192,
                     chunk_xy: int = 128, out_layout: str = "xyz",
                     scan_cap: int = 0, bf16: bool | None = None,
                     log=lambda m: None):
    """3D segmentation of a channel-summed (X, Y, Z) volume as a
    margin-tiled sweep along x.

    Global KMeans thresholds and one global seed mask keep every tile's
    masks equal to the whole volume's; each tile then labels and floods its
    slab of tile_x + 2 margin planes alone, and each voxel's label comes
    from the tile that owns it. A cell across a tile boundary is segmented
    by both tiles; the owning tile's private (uncropped) labels on the
    boundary plane pair show that the two ids are one cell, and a host
    union-find merges them (the smaller global id is the root). Exact for
    every structure narrower than ``margin``. ``scan_cap`` caps the tile id
    floods' scan doubling (0 = the margin); it changes the number of
    fixpoint rounds, never the result. ``bf16`` is the 3D LP-CV's sample
    precision (None: bf16 on CUDA, f32 on the CPU).

    Pass ``vol_sum`` as a one-element list to hand it over (it is popped,
    so it can be freed early). Returns (labels (X, Y, Z) int32, or
    (X, Z, Y) with out_layout="xzy"; n_cells int; None)."""
    if isinstance(vol_sum, list):
        vol_sum = vol_sum.pop()
    x, y, z = vol_sum.shape
    # the canonical (x, Z, Y) layout, once, while only vol_sum is live
    vol_xzy = vol_sum.permute(0, 2, 1).contiguous()
    del vol_sum
    vol_norm = vol_xzy / torch.clamp(torch.max(vol_xzy), min=1e-12)
    del vol_xzy
    logv = torch.log10(vol_norm + 1e-8)
    thr_bkg = _cluster_threshold(logv, 2, cfg.kmeans_iters)
    bkg = logv >= thr_bkg
    del logv
    enhanced = lp_cv_enhance_3d_chunked(vol_norm, cfg, chunk_xy, bf16,
                                        layout="xzy")
    del vol_norm
    log("enhanced")
    c2, c3 = km.kmeans1d_centers_multi(enhanced, (2, 3), cfg.kmeans_iters)
    thr_fg = (c2[-1] + c2[-2]) / 2.0
    thr_int = (c3[-1] + c3[-2]) / 2.0
    seeds = _global_seeds(enhanced, torch.maximum(thr_fg, thr_int))
    log("global seeds")

    n_tiles = -(-x // tile_x)
    pad_r = n_tiles * tile_x - x + margin
    box = [(_edge_pad_x(enhanced, margin, pad_r),
            _edge_pad_x(bkg, margin, pad_r),
            _edge_pad_x(seeds, margin, pad_r))]
    del enhanced, bkg, seeds
    statics = (cfg.lp_seed_min_size, cfg.ccl_max_iters,
               cfg.watershed_max_iters, tile_cap, scan_cap)
    tiles_seg, presents, planes = _tiled_segment_pass(
        box, thr_fg, statics, (tile_x, margin, n_tiles), log)

    # host union-find; the global id of tile t's local rank r is
    # t * tile_cap + r
    present = torch.stack(presents).cpu().numpy()
    pair_sets = [p.cpu().numpy() for p in
                 _boundary_pair_codes(tiles_seg, planes, tile_cap)]
    del planes
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for t in range(n_tiles - 1):
        if (t + 1) * tile_x >= x:
            break
        for code in pair_sets[t].tolist():
            union(t * tile_cap + code // tile_cap,
                  (t + 1) * tile_cap + code % tile_cap)
    all_ids = [t * tile_cap + int(r)
               for t in range(n_tiles)
               for r in np.flatnonzero(present[t][1:]) + 1]
    roots = sorted({find(i) for i in all_ids})
    root_rank = {r: i + 1 for i, r in enumerate(roots)}
    remap = np.zeros(n_tiles * tile_cap, np.float32)
    for i in all_ids:
        remap[i] = min(root_rank[find(i)], max_cells - 1)
    n_cells = min(len(roots), max_cells - 1)
    log(f"merge: {n_cells} cells")

    # remap tile by tile, freeing each original, then assemble once
    remap_dev = torch.from_numpy(remap).to(tiles_seg[0].device)
    remapped = []
    while tiles_seg:
        remapped.append(_remap_tile(tiles_seg.pop(0), remap_dev,
                                    len(remapped), tile_cap))
    seg = torch.cat(remapped, dim=0)[:x]
    del remapped
    if out_layout != "xzy":
        seg = seg.permute(0, 2, 1).contiguous()
    return seg, n_cells, None


# ---------------------------------------------------------------------------
# Streamed measurement
# ---------------------------------------------------------------------------


def make_fused_measure(loader_fn, shape, z_chunk: int, n_channels: int,
                       max_cells: int):
    """Whole-volume streamed measurement for a channels-major slab loader
    ``loader_fn(z0, zc) -> (C, zc, X, Y)``: returns ``run(seg_zxy) ->
    ((max_cells, C) mean spectra, spill=False)`` taking the (Z, X, Y)
    label volume. The z-chunks are swept in a Python loop, one chunk of
    spectra alive at a time, each reduced by stats_cm (kernel B5 on CUDA)
    into one table that it adds to in place. Label 0 is not accumulated,
    so row 0 is zero."""
    z = shape[2]

    def run(seg_zxy: torch.Tensor):
        acc = torch.zeros((max_cells, 1 + n_channels), dtype=torch.float32,
                          device=seg_zxy.device)
        for z0 in range(0, z, z_chunk):
            zc = min(z_chunk, z - z0)
            segstats.stats_cm(seg_zxy[z0:z0 + zc], loader_fn(z0, zc),
                              max_cells, out=acc)
        return acc[:, 1:] / torch.clamp(acc[:, :1], min=1.0), False

    return run


def measure_volume_streamed(seg: torch.Tensor, chunk_loader, z_total: int,
                            z_chunk: int, n_channels: int, max_cells: int,
                            channels_major: bool = False) -> torch.Tensor:
    """Per-cell mean spectra (max_cells, C) of an (X, Y, Z) label volume
    whose C-channel data arrives in z-slabs from ``chunk_loader(z0, zc)``:
    (C, zc, X, Y) with channels_major (reduced by stats_cm, kernel B5 on
    CUDA), else (X, Y, zc, C) (reduced by label_stats, kernel B3 on
    CUDA). Label 0 is not accumulated, so row 0 is zero."""
    if channels_major:
        run = make_fused_measure(chunk_loader, seg.shape, z_chunk,
                                 n_channels, max_cells)
        return run(seg.permute(2, 0, 1).contiguous())[0]
    sums = torch.zeros((max_cells, n_channels), dtype=torch.float32,
                       device=seg.device)
    counts = torch.zeros((max_cells,), dtype=torch.float32,
                         device=seg.device)
    for z0 in range(0, z_total, z_chunk):
        zc = min(z_chunk, z_total - z0)
        st = segstats.label_stats(seg[:, :, z0:z0 + zc].contiguous(),
                                  chunk_loader(z0, zc), max_cells)
        sums += st.sums
        counts += st.counts
    return sums / torch.clamp(counts, min=1.0)[:, None]


# ---------------------------------------------------------------------------
# The z-slice front end of the biofilm 2D engine
# ---------------------------------------------------------------------------


def segment_zstack_slice(image_stack_4d, z: int,
                         cfg: SegmentationConfig = SegmentationConfig(),
                         max_cells: int = 4096):
    """(Segmentation2D, plane): the biofilm LP-CV engine on plane ``z`` of
    a registered (X, Y, Z, C) stack."""
    plane = torch.as_tensor(image_stack_4d)[:, :, z, :]
    return segment2d.segment_lpcv_from_registered(plane, cfg, max_cells,
                                                  "biofilm"), plane


def measure_biofilm_images_2d_from_zstack_cli(
        sample, clf, taxon_lookup, z_indices, cfg=SegmentationConfig(),
        max_cells=4096, device=torch.device("cuda")):
    """Per-z biofilm measurement of a z-stack: load the per-laser stacks
    '{sample}_<laser>.npy' ((Z, H, W, C_l); a .czi raises, ROADMAP §A.7),
    register them on ``device`` (the card unless the caller names the
    CPU), and for each requested z segment the plane and write
    {sample}_z_{z}_registered.npy, _seg.npy, _adjacency_seg.npy,
    _cell_information.csv (headerless: features, barcode, sample, label,
    seven shape columns), _identification.npy and _adjacency_matrix.csv."""
    device = torch.device(device)
    volumes = []
    for laser in SEVEN_BIT.lasers:
        name = f"{sample}_{laser}.czi"
        if not os.path.exists(name):
            name = f"{sample}_{laser}.npy"
        volumes.append(torch.from_numpy(np.ascontiguousarray(
            iio.load_image_zstack_fixed_t(name), np.float32)).to(device))
    stack4d = register_volume_stack(volumes)
    del volumes
    for z in z_indices:
        res, plane = segment_zstack_slice(stack4d, z, cfg, max_cells)
        n = int(res.n_cells)
        tag = f"{sample}_z_{z}"
        seg = res.segmentation.cpu().numpy()
        np.save(f"{tag}_registered.npy", plane.cpu().numpy())
        np.save(f"{tag}_seg.npy", seg)
        np.save(f"{tag}_adjacency_seg.npy", res.adjacency.cpu().numpy())
        _, avgint_norm = meas.measure_fov(res.segmentation, plane, n,
                                          max_cells)
        codes, _, _, feats = classifier.classify(clf, avgint_norm, device)
        props = rp.shape_props_2d(res.segmentation, max_cells)
        outputs.write_frame(
            f"{tag}_cell_information.csv",
            [(j, feats[:, j]) for j in range(feats.shape[1])]
            + [("barcode", np.array(codes, dtype=object)),
               ("sample", np.full(n, sample, dtype=object)),
               ("label", np.arange(1, n + 1))]
            + [(k, props[k][1:n + 1].cpu().numpy()) for k in SHAPE_COLUMNS],
            header=False)
        np.save(f"{tag}_identification.npy",
                bf.paint_taxon_identification(seg, codes, taxon_lookup, n))
        pairs = bf.adjacency_label_pairs(res.adjacency.cpu().numpy())
        mcodes, mat, _ = bf.adjacency_matrix_from_pairs(pairs, codes,
                                                        taxon_lookup)
        bf.save_adjacency_matrix(f"{tag}_adjacency_matrix.csv", mcodes, mat)
