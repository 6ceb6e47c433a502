"""The 3D biofilm paths in PyTorch (port of
hiprfish_tpu/pipeline/segment3d.py).

The tiled volume engine: stitch_tiles_device -> segment_3d_tiled (3D
LP-CV, kernel B6 -> global KMeans thresholds -> global seed mask ->
margin-tiled CCL + rank + seed size filter (B3, B4) + watershed -> host
union-find over the tile boundaries -> remap (B4)) ->
measure_volume_streamed / make_fused_measure (per-cell spectra streamed
over z-slabs, B5 for channels-major slabs, B3 otherwise). Classification
is pipeline/fused.classify_device. From the moment segment_3d_tiled has
the summed volume it works in the canonical (X, Z, Y) layout, as the
reference does: component ids (the minimum linear index), their ranks,
the KMeans histogram's strided subsample and the union-find's smaller root
all follow linear order in that layout, so the cell numbering and
thresholds are the reference's.

The untiled engine of one z-stack (cli.biofilm -d 3):
measure_biofilm_images_3d reads the per-laser stacks, register_volume_stack
aligns them on their log channel sums into one (X, Y, Z, C) cube,
segment_3d_from_sum segments the channel sum as one volume (3D LP-CV, B6;
KMeans masks; opening; the seed size filter remove_small_objects_fast, B3
and B4; fill-holes; CCL + rank; watershed), and the cells' mean spectra,
calls, 3D shape columns, identification image and Blender volumes are
written. This engine works in (X, Y, Z): its component ids, ranks and
KMeans subsample follow linear order there, as the reference's do.

The z-slice front end (segment_zstack_slice,
measure_biofilm_images_2d_from_zstack_cli) runs the 2D biofilm engine on
single planes of the registered stack (kernels B1 and B2 on the card);
register_tstack_average and the host stitch_tiles are the reference's
time-series average and numpy tile stitcher.

Everything runs eagerly on the device of its inputs. Where the reference
branched inside a compiled program or spilled a fixed-size device buffer,
the port reads a small result back to the host: the registration and
stitch shifts once, the seed filter's component count, the boundary pair
sets (torch.unique per boundary is exact, so the reference's pair cap and
its full-plane fallback are not needed) and the per-tile presence
bitmaps.
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


def _on(volume, device) -> torch.Tensor:
    """``volume`` (an array or tensor) as a tensor on ``device``, copied
    across in its own memory order: a z-stack read as (X, Y, Z, C) is a
    view of a (Z, X, Y, C) array, and the copy keeps it so."""
    t = torch.as_tensor(volume)
    if device is None or t.device == torch.device(device):
        return t
    order = sorted(range(t.ndim), key=t.stride, reverse=True)
    back = [order.index(d) for d in range(t.ndim)]
    return t.permute(order).to(device).permute(back)


def register_tstack_average(volumes):
    """Average a time series of (X, Y, Z, C) volumes after registering each
    to the first on their channel sums (each shift read to the host
    once)."""
    ref = torch.as_tensor(volumes[0])
    ref_sum = fp.sum_in_order(ref, 3)
    acc = ref
    for v in volumes[1:]:
        vol = torch.as_tensor(v)
        shift = reg.register_translation_3d(ref_sum, fp.sum_in_order(vol, 3))
        acc = acc + reg.apply_shift_3d(vol, shift)[0]
    return acc / len(volumes)


def register_volume_stack(volume_stack, device=None, shifts=None):
    """Register per-laser (X, Y, Z, C_l) volumes to laser 0 by 3D phase
    correlation of the logs of their channel sums, each shift read to the
    host once, and concatenate the channels: (X, Y, Z, C) in the first
    volume's dtype, zeros where a shifted laser has no data.

    Each laser is written, shifted, into its channel slice of one
    preallocated cube and let go of once its log sum and shift are done.
    Pass ``volume_stack`` as a list to hand the volumes over: it is
    emptied, so only one input volume is alive beside the cube. The
    volumes may be host arrays; each goes to ``device`` (default: the
    first volume's) in its turn. ``shifts``, a list, receives each laser's
    (x, y, z) shift as ints (laser 0's is zeros)."""
    vols = volume_stack if isinstance(volume_stack, list) \
        else list(volume_stack)
    first = torch.as_tensor(vols[0])
    x, y, z = first.shape[:3]
    dtype = first.dtype
    dev = first.device if device is None else torch.device(device)
    del first
    channels = sum(v.shape[3] for v in vols)
    out = torch.empty((x, y, z, channels), dtype=dtype, device=dev)
    ref, c0 = None, 0
    while vols:
        vol = _on(vols.pop(0), dev)
        log_sum = torch.log(fp.sum_in_order(vol, 3) + 1e-8)
        if ref is None:
            ref, shift = log_sum, (0, 0, 0)
        else:
            shift = tuple(int(v) for v in reg.register_translation_3d(
                ref, log_sum).tolist())
        del log_sum
        reg.shift_into(out[..., c0:c0 + vol.shape[3]], vol, shift)
        c0 += vol.shape[3]
        del vol
        if shifts is not None:
            shifts.append(shift)
    return out


def stitch_tiles(tile_volumes, tile_masks, grid, tile_shape, overlap: int,
                 out_shape, pad: int = 10, device=torch.device("cuda")):
    """Host stitching of microscope tiles (host arrays) into one volume,
    blended by overlap counts: chain phase-correlation registration of
    50-deep strips along the first row and column (on ``device``, the card
    unless the caller names the CPU), then accumulate intensity and hit
    counts in numpy and divide. Returns the float32 ``out_shape``
    volume."""
    gy, gx = grid
    shift_full = np.zeros((gy, gx, 3))
    for i in range(gy):
        for j in range(gx):
            if i == 0 and j == 0:
                continue
            if j == 0:
                a = tile_volumes[(i - 1) * gx][-50:]
                b = tile_volumes[i * gx][:50]
            else:
                a = tile_volumes[i * gx + j - 1][:, -50:]
                b = tile_volumes[i * gx + j][:, :50]
            shift_full[i, j] = reg.register_translation_3d(
                torch.from_numpy(np.ascontiguousarray(a)).to(device),
                torch.from_numpy(np.ascontiguousarray(b)).to(device)) \
                .cpu().numpy()
    full = np.zeros(out_shape, np.float32)
    count = np.zeros(out_shape, np.float32)
    ty, tx, tz = tile_shape
    step_y = ty - overlap
    step_x = tx - overlap
    for i in range(gy):
        for j in range(gx):
            sy = int(i * step_y + shift_full[: i + 1, 0, 0].sum()
                     + shift_full[i, 1: j + 1, 0].sum()) + pad
            sx = int(j * step_x + shift_full[i, : j + 1, 1].sum()) + pad
            sz = int(shift_full[i, : j + 1, 2].sum()) + pad
            vol = np.asarray(tile_volumes[i * gx + j])
            msk = np.asarray(tile_masks[i * gx + j]).astype(np.float32)
            full[sy:sy + ty, sx:sx + tx, sz:sz + tz] += vol * msk
            count[sy:sy + ty, sx:sx + tx, sz:sz + tz] += msk
    count[count == 0] = 1
    return full / count


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
# The untiled engine
# ---------------------------------------------------------------------------


def _segment_post_enhance(enhanced, bkg, statics):
    """Everything after the 3D LP-CV sweep on the whole (X, Y, Z) volume:
    the k = 2 / 3 brightest-cluster masks, an opening, the seed size
    filter (B3 counts and a B4 lookup of the keep table), fill-holes of
    the seeds (inside the foreground, so the foreground needs no fill of
    its own), CCL + rank of the seeds inside the background mask, and the
    watershed over -enhanced. Returns (labels int32, n_cells int)."""
    kmeans_iters, seed_min, ccl_iters, ws_iters, max_cells = statics
    pos = enhanced > 0
    fg3, int3 = km.brightest_cluster_masks(enhanced, (2, 3), kmeans_iters)
    fg = fg3 & pos
    interior = morph.binary_opening(int3 & pos & fg)
    interior = segstats.remove_small_objects_fast(
        interior, seed_min, 3, max_iters=ccl_iters, exact_fallback=False)
    seeds_mask = morph.binary_fill_holes(interior, 1, 64)
    del interior
    markers, n_cells = segstats.rank_labels(
        lab.label(seeds_mask & bkg, 3, ccl_iters), 3, ccl_iters)
    markers = torch.clamp(markers, max=max_cells - 1)
    seg = ws.watershed(-(enhanced.to(torch.float32) * bkg), markers,
                       seeds_mask | (fg & bkg), 1, ws_iters)
    return seg, min(int(n_cells), max_cells - 1)


def segment_3d_from_sum(vol_sum,
                        cfg: SegmentationConfig = SegmentationConfig(),
                        max_cells: int = 16384, chunk_xy: int = 128,
                        bf16: bool | None = None):
    """3D LP-CV segmentation of a channel-summed (X, Y, Z) volume as one
    volume, on the device of ``vol_sum``: log10 KMeans background, 3D
    LP-CV (kernel B6 through the (X, Z, Y) permute on CUDA; ``bf16=None``
    is bf16 there and f32 on the CPU; ``chunk_xy`` bounds only the plain
    version's memory), then _segment_post_enhance. The floods keep the
    reference's caps and run without a scan cap.

    Pass ``vol_sum`` as a one-element list to hand it over (it is popped,
    so it can be freed early). Returns (labels (X, Y, Z) int32, n_cells
    int, enhanced (X, Y, Z) f32)."""
    if isinstance(vol_sum, list):
        vol_sum = vol_sum.pop()
    vol_norm = vol_sum / torch.clamp(torch.max(vol_sum), min=1e-12)
    del vol_sum
    bkg = km.brightest_cluster_mask(torch.log10(vol_norm + 1e-8), 2,
                                    cfg.kmeans_iters)
    enhanced = lp_cv_enhance_3d_chunked(vol_norm, cfg, chunk_xy, bf16)
    del vol_norm
    statics = (cfg.kmeans_iters, cfg.lp_seed_min_size, cfg.ccl_max_iters,
               cfg.watershed_max_iters, max_cells)
    seg, n_cells = _segment_post_enhance(enhanced, bkg, statics)
    return seg, n_cells, enhanced


def segment_3d(volume_stack, cfg: SegmentationConfig = SegmentationConfig(),
               max_cells: int = 16384, chunk_xy: int = 128,
               bf16: bool | None = None, device=None, shifts=None):
    """3D LP-CV segmentation of per-laser (X, Y, Z, C_l) volumes:
    register_volume_stack (to ``device``, default the first volume's;
    ``shifts`` receives the shifts; a list of volumes is emptied), the
    channel sum in the reference's order, segment_3d_from_sum. Returns
    (labels (X, Y, Z) int32, n_cells int, registered (X, Y, Z, C),
    enhanced)."""
    registered = register_volume_stack(volume_stack, device, shifts)
    seg, n_cells, enhanced = segment_3d_from_sum(
        [fp.sum_in_order(registered, 3)], cfg, max_cells, chunk_xy, bf16)
    return seg, n_cells, registered, enhanced


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


def _load_stacks(sample) -> list:
    """The per-laser z-stacks '{sample}_<laser>.npy' as host (X, Y, Z, C_l)
    float32 arrays ('{sample}_<laser>.czi' where one exists, which
    raises: ROADMAP §A.7)."""
    volumes = []
    for laser in SEVEN_BIT.lasers:
        name = f"{sample}_{laser}.czi"
        if not os.path.exists(name):
            name = f"{sample}_{laser}.npy"
        volumes.append(np.asarray(iio.load_image_zstack_fixed_t(name),
                                  np.float32))
    return volumes


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
    stack4d = register_volume_stack(_load_stacks(sample), device)
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


# ---------------------------------------------------------------------------
# The volumetric analysis of a z-stack
# ---------------------------------------------------------------------------


def measure_biofilm_images_3d(sample, clf, taxon_lookup,
                              cfg=SegmentationConfig(), max_cells=16384,
                              save_bvox=True, device=torch.device("cuda"),
                              timings=None, shifts=None):
    """The volumetric biofilm analysis of one z-stack with a
    models/artifacts ClassifierArrays: read the per-laser stacks
    '{sample}_<laser>.npy' ((Z, H, W, C_l); a .czi raises, ROADMAP §A.7),
    register them on ``device`` (the card unless the caller names the
    CPU), segment the channel sum as one volume (segment_3d_from_sum),
    and write {sample}_registered.npy, _seg.npy, _cell_information.csv
    (features, barcode, probability, sample, label, 3D centroid, area,
    type), _identification.npy and, with ``save_bvox``, the Blender
    volumes _identification_{r,g,b}.bvox and _raw_image.bvox (the channel
    sum). A cell is debris above 100,000 voxels or at a probability of at
    most cfg.debris_prob_min. Returns the cell table as [(column, values),
    ...].

    The host reads all stacks first; each goes to the device, and its
    host copy is freed, in its turn. ``timings``, a dict, receives each
    stage's seconds (read, register, segment, measure, classify,
    artifacts); ``shifts``, a list, the registration shifts."""
    device = torch.device(device)
    lap = bf.stage_timer(timings, device)
    volumes = _load_stacks(sample)
    lap("read")
    registered = register_volume_stack(volumes, device, shifts)
    lap("register")
    seg, n, _ = segment_3d_from_sum([fp.sum_in_order(registered, 3)], cfg,
                                    max_cells)
    lap("segment")
    avgint = rp.mean_intensities(seg, registered, max_cells)[1:n + 1] \
        .cpu().numpy()
    avgint_norm = avgint / np.maximum(avgint.max(axis=1, keepdims=True),
                                      1e-12)
    props = {k: v[1:n + 1].cpu().numpy() for k, v in
             rp.shape_props_3d(seg, max_cells).items()}
    lap("measure")
    codes, max_prob, _, feats = classifier.classify(clf, avgint_norm, device)
    lap("classify")
    debris = (props["area"] > 100000) | (max_prob <= cfg.debris_prob_min)
    table = (bf._feature_columns(feats, clf.n_channels)
             + [("cell_barcode", np.array(codes, dtype=object)),
                ("max_probability", max_prob),
                ("sample", np.full(n, sample, dtype=object)),
                ("label", np.arange(1, n + 1))]
             + [(k, props[k]) for k in ("centroid_x", "centroid_y",
                                        "centroid_z", "area")]
             + [("type", np.where(debris, "debris", "cell").astype(object))])
    outputs.save_npy(f"{sample}_registered.npy", registered)
    seg_np = seg.cpu().numpy()
    del seg
    np.save(f"{sample}_seg.npy", seg_np)
    outputs.write_frame(f"{sample}_cell_information.csv", table)
    ident = bf.paint_taxon_identification(seg_np, codes, taxon_lookup, n)
    np.save(f"{sample}_identification.npy", ident)
    if save_bvox:
        outputs.save_identification_bvox(ident, sample)
        outputs.save_bvox(fp.sum_in_order(registered, 3).cpu().numpy(),
                          f"{sample}_raw_image.bvox")
    lap("artifacts")
    return table
