#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (hiprfish_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the script exits
non-zero and prints no result:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the six CUDA kernels from csrc/ (one nvcc per source) and, in
     parallel with them, B6's instance for the configuration (7, 5, 6) of
     phase 13; print the build time and ptxas's registers and spills of
     B1, B3/B4/B5 and B6;
  3. run the 2D kernels against their plain-torch twins on the card at the
     main path's shapes (2000^2 images; B3 on the 2000^2 label image with
     16384 segments at the column sets the paths launch: counts only, counts
     + a 41-class erosion-depth histogram, and the bf16 (2000, 2000, 63)
     cube; B4 with a 16384-entry table), and print the max error against
     the stated tolerance, both median times, the kernel's bound
     (kernel_work) and its share of it, and the time of one PyTorch call
     that computes the same function where there is one (library_ms; timed
     here only, the port never calls it). B3 must agree bitwise with its
     twin on every integer column (count, border, moments, aux, mask) and
     give the same bits in a second launch;
  4. run the port's fov_step on a 256^2 FOV on the CPU (plain versions) and
     on the card (kernels), and hold the two results together;
  5. run fov_step on the 2000^2 7-bit FOV (400 planted cells) with the
     committed 127-code classifier and max_cells=8192; every 2D kernel's
     launch count must rise during that call; barcode accuracy against the
     planted truth must be >= 0.99 over >= 380 matched cells; print ms/FOV
     (median of 5 synchronised calls after the counted one) and n_cells of
     all six calls, which must be equal;
  6. build the 3D fixture (tools/bench3d.py's 2020 x 2020 x 170 volume,
     9,408 planted cells, seed 5) on the card; hold B6 (3D LP-CV, bf16)
     against its plain twin on a 256 x 170 x 256 (X, Z, Y) sub-volume and
     on the whole normalised 2020 x 170 x 2020 (X, Z, Y) volume, the shape
     the 3D path gives it (the plain twin timed once there), and B5
     (channels-major stats) against its plain twin on a bf16
     (63, 2, 2020, 2020) slab with 16384 segments (with bounds and library
     calls as in 3); then B3 (counts) and B4 on a 3D tile's labels as
     segment_3d_tiled gives them, (360 + 2 x 64) x 170 x 2020 (the planted
     cells of the tile's slab, ranked within it, 8192 segments);
  7. run segment_3d_tiled on the 144 x 96 x 40 volume of the JAX package's
     tiled test on the CPU (plain versions) and on the card (kernels), both
     in bf16 LP-CV mode: equal n_cells, segmentation agreement >= 0.9999;
  8. run the 3D volume path once at full size, as tools/bench3d.py composes
     it: cut 2 x 4 shifted microscope tiles (60-px overlap) -> stitch ->
     segment_3d_tiled(max_cells=16384, tile_x=360, margin=64,
     tile_cap=8192, scan_cap=32) -> measure with bf16 channels-major slabs
     (z_chunk=2, B5) -> classify; n_cells must be 9,408 and barcode
     accuracy >= 0.99 over >= 9,300 matched cells, and B3, B4, B5 and B6
     must all launch; print each stage's seconds (synchronised), the total
     and the peak device memory;
  9. build the 10-bit E. coli FOV (bench.py's 10-bit configuration: 2000^2,
     5 lasers, 95 channels, 400 planted cells) and hold B3 against its
     plain twin at the 10-bit step's column set: the truth labels with
     16384 segments, the bf16 (2000^2, 95) cube, an aux image in [0, 41),
     moments and a 0/1 mask; count, border, moment, aux and mask columns
     bitwise equal to the twin's and to a second launch's, channel sums
     within 2^-16 relative;
 10. run the port's fov_step_ecoli on a 256^2 10-bit FOV on the CPU (plain
     versions) and on the card (kernels): equal n_cells and calls,
     segmentation agreement >= 0.999;
 11. run fov_step_ecoli on the 2000^2 10-bit FOV with the committed
     1023-class classifier and max_cells=8192; B3 and B4 must launch;
     barcode accuracy >= 0.99 over >= 380 matched cells; print ms/FOV
     (median of 5 synchronised calls after the counted one) and n_cells of
     all six calls, which must be equal;
 12. run the host engine once on the same FOV (segment2d.segment_ecoli ->
     measure.measure_fov -> the 132-d features -> fused.classify_device):
     the same accuracy bar; print each stage's seconds;
 13. hold B1, B2 and B6 against their plain twins at configurations other
     than the main paths' and time both: B1 at patch 7, pd 80 (its
     global-memory geometry), B2 at (7, 5) and (15, 12) (a 96 x 160
     image), B6 at (7, 5, 6) in bf16 and f32 (a 40 x 24 x 36 volume).

The line before the last is a JSON object with one entry per kernel (its
launches on each path, errors, times, bound and library call); the last
line is {"ok": true, "device": {...}}. The script imports neither jax
nor the JAX package hiprfish_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the committed 127-code and 1023-class classifiers and the 2D steps' cell
# capacity; the FOVs are hiprfish_tpu_torch.utils.synthetic.flagship_fov
# and ecoli_fov
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "torch_port_clf_7b_127x50.npz")
FIXTURE_10B = os.path.join(os.path.dirname(FIXTURE),
                           "torch_port_clf_10b_1023x200.npz")
MAX_CELLS = 8192
# kernel vs plain tolerances on the card (absolute unless EXACT_COLS
# names the table's exact count columns; the sums are then relative)
TOL = {
    # NLM: weights exp(-d2/h^2) amplify f32 rounding of the box sums by
    # 1/h^2 = 2500; the kernel sums 49 terms directly where the plain
    # version differences cumulative sums
    "nlm": 1e-5,
    "lpcv2d": 1e-6,
    "label_lookup": 0.0,
    # B5 as B3: counts exact, channel sums within 2^-16 relative
    "stats_cm": 2.0 ** -16,
    # B6: the same bf16 samples and f32 ratios; only the f32 summation
    # order of the 72-orientation mean differs
    "lpcv3d": 1e-6,
}
# leading columns that must agree exactly (counts)
EXACT_COLS = {"stats_cm": 1}
TOL_TEXT = {
    "nlm": f"tol {TOL['nlm']:.0e} abs",
    "lpcv2d": f"tol {TOL['lpcv2d']:.0e} abs",
    # B3 (_agree_b3): the columns whose terms are integers are exact
    "label_stats": "integer columns bitwise, twice; sums tol 2^-16 rel",
    "label_lookup": "exact",
    "stats_cm": "counts exact, sums tol 2^-16 rel",
    "lpcv3d": f"tol {TOL['lpcv3d']:.0e} abs",
}
REPLACES = {
    "nlm": "hiprfish_tpu/ops/nlm_pallas.py:399",
    "lpcv2d": "hiprfish_tpu/ops/lp_pallas.py:72",
    "label_stats": "hiprfish_tpu/ops/segstats_pallas.py:168",
    "label_lookup": "hiprfish_tpu/ops/segstats_pallas.py:452",
    "stats_cm": "hiprfish_tpu/ops/segstats_pallas.py:327",
    "lpcv3d": "hiprfish_tpu/ops/lp3d_pallas.py:198",
}
SOURCES = {
    "nlm": "hiprfish_tpu_torch/csrc/nlm.cu",
    "lpcv2d": "hiprfish_tpu_torch/csrc/lpcv2d.cu",
    "label_stats": "hiprfish_tpu_torch/csrc/segstats.cu",
    "label_lookup": "hiprfish_tpu_torch/csrc/segstats.cu",
    "stats_cm": "hiprfish_tpu_torch/csrc/segstats.cu",
    "lpcv3d": "hiprfish_tpu_torch/csrc/lpcv3d.cu",
}
PATH_2D = ("nlm", "lpcv2d", "label_stats", "label_lookup")
PATH_3D = ("label_stats", "label_lookup", "stats_cm", "lpcv3d")
PATH_ECOLI = ("label_stats", "label_lookup")
# the order of the kernels line: B3 once per column set, B4 once per shape
REPORT_ORDER = ("nlm", "lpcv2d", "label_stats[counts]", "label_stats[aux41]",
                "label_stats[cube7b]", "label_stats[cols10b]",
                "label_stats[tile3d]", "label_lookup[2000^2]",
                "label_lookup[tile3d]", "stats_cm", "lpcv3d")
# the 10-bit step's erosion-depth histogram has max_erosion_iters + 1
# classes
AUX_CLASSES_10B = 41
# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): f32
# outside the tensor cores, and HBM3 bandwidth
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# operations per output element, each min, max, add, mul, compare, divide
# and exp one op and an FMA two (the sources' notes derive them):
# B1 per pixel and offset: squared difference 2, box sum as running column
# and row sums 4, weight 3 (clamp, multiply by log2(e) / (area h^2), exp2:
# the area and h^2 fold into one constant), two accumulations (acc += w P,
# wacc += w) 3 each
OPS_NLM = 15
# B2 per pixel: 9 x 10 x 2 min/max, 9 ratios x 4, the mean 9, the optimal
# 25-comparator sort of 9 x 2, the quartile combine 6
OPS_LPCV2D = 9 * 10 * 2 + 9 * 4 + 9 + 25 * 2 + 6
# B6 per voxel: 72 x 10 x 2 min/max, 72 ratios x 4, the mean 72, the 640
# compare-exchanges of the quartile network x 2, the combine 10
OPS_LPCV3D = 72 * 10 * 2 + 72 * 4 + 72 + 640 * 2 + 10
# the 3D volume of tools/bench3d.py and its segmentation settings
SHAPE_3D = (2020, 2020, 170)
MAX_CELLS_3D = 16384
TILED_3D = dict(tile_x=360, margin=64, tile_cap=8192, scan_cap=32)
# the configurations of phase 13: (h, w, patch, pd) of B1, the (patch,
# phi) of B2 and the (patch, theta, phi) of B6
DOMAIN_NLM = (96, 160, 7, 80)
DOMAIN_LPCV2D = ((7, 5), (15, 12))
DOMAIN_LPCV3D = (7, 5, 6)


def kernel_work(name: str, **a) -> tuple[float, float]:
    """(operations, bytes) that kernel ``name`` must at least do on the
    given inputs: each input byte read once and each output byte written
    once. The label kernels' work depends on the data: they count only the
    ``labelled`` pixels' channel rows (``row_bytes`` each) and one add per
    column of each; ``px_bytes`` are other per-pixel inputs (aux, mask)."""
    if name == "nlm":
        pd = a["pd"]
        px = a["h"] * a["w"]
        return px * ((2 * pd + 1) ** 2 - 1) // 2 * OPS_NLM, 8 * px
    if name == "lpcv2d":
        px = a["h"] * a["w"]
        return px * OPS_LPCV2D, 8 * px
    if name == "lpcv3d":
        return a["voxels"] * OPS_LPCV3D, 8 * a["voxels"]
    if name == "label_lookup":
        return a["pixels"], 8 * a["pixels"] + 4 * a["segments"]
    if name in ("label_stats", "stats_cm"):
        n, lab, ncols = a["pixels"], a["labelled"], a["ncols"]
        return lab * ncols, (n * (4 + a.get("px_bytes", 0))
                             + lab * a["row_bytes"]
                             + 4 * a["segments"] * ncols)
    raise ValueError(f"kernel_work: unknown kernel {name}")


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations over the f32 peak and the bytes over the
    memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _time_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn`` in ms (CUDA events): the median
    over 3 batches of the mean of ceil(reps / 3) calls queued back to back,
    after one warm call. Each batch waits behind a spin kernel long enough
    for the host to enqueue it, so that the host's launch overhead (tens of
    microseconds of Python per call) stays off the device's timeline; a
    call that synchronises with the host pays it all the same."""
    per = max(1, -(-reps // 3))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # the card's clock is below 2 GHz: this many cycles last at least as
    # long as 1.5 x the host's enqueue time of the batch (capped at 0.2 s)
    cycles = int(2e9 * min(1.5 * per * host_s, 0.2))
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def _time_once(torch, fn):
    """(output, device time in ms) of one call of ``fn`` (CUDA events), for
    a call too slow to repeat."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _agree(torch, name, out_k, out_p):
    """(max abs error, within tolerance) of a kernel's output against its
    plain twin's."""
    diff = (out_k - out_p).abs()
    err = float(diff.max())
    k = EXACT_COLS.get(name)
    if k is None:
        return err, err <= TOL[name]
    rel = float((diff[:, k:] / out_p[:, k:].abs().clamp(min=1.0)).max())
    return err, (bool(torch.equal(out_k[:, :k], out_p[:, :k]))
                 and rel <= TOL[name])


def _barcode_accuracy(seg, truth, codes_pred, cell_codes, codebook, layout,
                      n_found: int, max_cells: int):
    """Majority-overlap match of found cells to planted cells, then the
    fraction whose called barcode is the planted one (bench.py's rule)."""
    pairs = (seg.astype(np.int64) << 32) | truth.astype(np.int64)
    vals, cnt = np.unique(pairs, return_counts=True)
    s = vals >> 32
    t = vals & 0xFFFFFFFF
    keep = (s > 0) & (s <= min(n_found, max_cells - 1)) & (t > 0)
    s, t, cnt = s[keep], t[keep], cnt[keep]
    order = np.argsort(cnt, kind="stable")
    majority = {}
    for si, ti in zip(s[order], t[order]):
        majority[int(si)] = int(ti)        # ascending counts: last wins
    correct = sum(codebook[codes_pred[lab]] ==
                  layout.code_str(cell_codes[tid - 1])
                  for lab, tid in majority.items())
    return correct, len(majority)


def _volume_stack(codes, shape):
    """The (X, Y, Z, 63) spectral volume of the JAX package's tiled 3D test
    (tests/test_biofilm_and_3d.py::_make_volume_stack): ellipsoidal cells
    on a grid, one barcode spectrum each, uniform noise."""
    from hiprfish_tpu_torch.config import SEVEN_BIT
    from hiprfish_tpu_torch.utils import synthetic

    rng = np.random.RandomState(0)
    x, y, z = shape
    lut = synthetic.fluorophore_spectra(SEVEN_BIT)
    vol = rng.rand(x, y, z, SEVEN_BIT.n_channels).astype(np.float32) * 0.01
    grid = int(np.ceil(len(codes) ** 0.5))
    xs = np.linspace(12, x - 12, grid)
    ys = np.linspace(12, y - 12, grid)
    xx, yy, zz = np.mgrid[:x, :y, :z]
    for i, c in enumerate(codes):
        r2 = (((xx - xs[i // grid]) / 6.0) ** 2
              + ((yy - ys[i % grid]) / 4.0) ** 2 + ((zz - z / 2) / 5.0) ** 2)
        profile = np.where(r2 <= 1.0, 1.0 - 0.2 * np.sqrt(np.clip(r2, 0, 1)),
                           0.0)
        vol += profile[..., None] * synthetic.barcode_spectrum(
            SEVEN_BIT, c, lut)[None, None, None, :]
    return vol


def _accuracy_3d(torch, s3, spec, n_codes, seg_xzy, pred, lut_class,
                 n_found: int, max_cells: int):
    """tools/bench3d.py's rule: each found label takes the planted barcode
    that covers most of its voxels; accuracy is the fraction of labels
    with planted voxels whose call is that barcode. Returns (correct,
    matched)."""
    dev = seg_xzy.device
    counts = torch.zeros(max_cells * n_codes, dtype=torch.int64, device=dev)
    for z0 in range(0, spec.shape[2], 10):
        zc = min(10, spec.shape[2] - z0)
        truth, code, _ = s3.truth_chunk(spec, n_codes, z0, zc, dev)
        seg = seg_xzy[:, z0:z0 + zc, :].permute(0, 2, 1).to(torch.int64)
        flat = torch.where(truth > 0, seg * n_codes + code, 0).reshape(-1)
        counts += torch.bincount(flat, minlength=max_cells * n_codes)
    counts = counts.reshape(max_cells, n_codes).cpu().numpy()
    counts[0] = 0
    has_truth = counts.sum(axis=1) > 0
    truth_class = lut_class[counts.argmax(axis=1)]
    labs = np.arange(1, min(n_found, max_cells - 1) + 1)
    valid = has_truth[labs]
    correct = int((pred[labs][valid] == truth_class[labs][valid]).sum())
    return correct, int(valid.sum())


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _volume_tiles(torch, dev, spec, lut_dev, grid=(2, 4), overlap=60):
    """tools/bench3d.py's microscope tiles of the fixture volume: a 2 x 4
    grid with 60-px overlap, each tile's window offset by its own random
    shift (RandomState(3), first tile unshifted) and cut from the
    edge-padded scene, so shifted tiles see true content at their
    edges."""
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    shape = spec.shape
    vol = s3.build_sum_volume(spec, lut_dev.shape[0],
                              lut_dev.sum(dim=1).cpu(), seed=1, z_chunk=16,
                              device=dev)
    gy, gx = grid
    ty = (shape[0] + (gy - 1) * overlap) // gy
    tx = (shape[1] + (gx - 1) * overlap) // gx
    shift_rng = np.random.RandomState(3)
    tile_shifts = [tuple(shift_rng.randint(-3, 4, 3)) for _ in range(gy * gx)]
    tile_shifts[0] = (0, 0, 0)
    S = 3
    volp = torch.nn.functional.pad(vol[None, None], (S,) * 6,
                                   mode="replicate")[0, 0]
    del vol
    tiles = []
    for i in range(gy):
        for j in range(gx):
            dy, dx, dz = tile_shifts[i * gx + j]
            y0 = i * (ty - overlap) + S - dy
            x0 = j * (tx - overlap) + S - dx
            tiles.append(volp[y0:y0 + ty, x0:x0 + tx,
                              S - dz:S - dz + shape[2]].clone())
    return tiles


def _volume_step(torch, tile_box, spec, lut_dev, arrays, static, cfg,
                 tiled: dict, max_cells: int, z_chunk: int = 2,
                 log=lambda m: None) -> dict:
    """One 3D pass as tools/bench3d.py composes it, from the tiles (popped
    from the one-element list ``tile_box``, so they free after the
    stitch): stitch -> segment_3d_tiled (out_layout="xzy") -> measure
    bf16 channels-major slabs (make_fused_measure, B5) -> classify.
    Returns the labels, n_cells, mean spectra, calls and each stage's
    seconds (synchronised)."""
    from hiprfish_tpu_torch.config import SEVEN_BIT as layout
    from hiprfish_tpu_torch.pipeline import fused, segment3d
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    shape = spec.shape
    dev = lut_dev.device
    stages = {}
    t0 = time.time()
    tiles = tile_box.pop()
    stitched = segment3d.stitch_tiles_device(tiles, (2, 4), 60, shape,
                                             pad=10)
    del tiles
    stitched = stitched[10:10 + shape[0], 10:10 + shape[1],
                        10:10 + shape[2]].contiguous()
    _sync(torch, dev)
    stages["stitch"] = time.time() - t0
    t0 = time.time()
    box = [stitched]
    del stitched
    seg_xzy, n_cells, _ = segment3d.segment_3d_tiled(
        box, cfg, max_cells, out_layout="xzy", log=log, **tiled)
    _sync(torch, dev)
    stages["segment"] = time.time() - t0
    t0 = time.time()
    run = segment3d.make_fused_measure(
        lambda z0, zc: s3.channel_chunk_cm(spec, lut_dev.shape[0], z0, zc,
                                           lut_dev, 1, torch.bfloat16),
        shape, z_chunk, layout.n_channels, max_cells)
    avg, _ = run(seg_xzy.permute(1, 0, 2).contiguous())
    _sync(torch, dev)
    stages["measure"] = time.time() - t0
    t0 = time.time()
    norm = avg / torch.clamp(torch.max(avg, dim=1, keepdim=True).values,
                             min=1e-12)
    pred, _ = fused.classify_device(
        norm, arrays["check_heads"], static[6], arrays.get("scaler_mean"),
        arrays.get("scaler_scale"), arrays["train_features"],
        arrays["train_labels"], *static[:6])
    pred = pred.cpu().numpy()
    stages["classify"] = time.time() - t0
    return {"seg_xzy": seg_xzy, "n_cells": n_cells, "avg": avg,
            "pred": pred, "stages": stages}


def _volume_pass(torch, dev, spec, lut_dev, clf, cfg, tiled: dict,
                 max_cells: int) -> dict:
    """The 3D pass on ``dev`` with launches counted from zero, then its
    accuracy against the planted truth. Returns stage seconds, total,
    n_cells, correct/matched, launch counts and peak device memory."""
    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.config import SEVEN_BIT as layout
    from hiprfish_tpu_torch.pipeline import fused
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    tiles = _volume_tiles(torch, dev, spec, lut_dev)
    arrays, static = fused.classifier_from_numpy(clf, dev)
    n_codes = lut_dev.shape[0]
    lut_class = np.array([list(clf.codebook).index(layout.code_str(c + 1))
                          for c in range(n_codes)])
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_seg = time.time()

    def log(msg):
        _sync(torch, dev)
        print(f"phase 8   +{time.time() - t_seg:.2f} s: {msg}")

    # hand the tiles over, so that they free after the stitch
    tile_box = [tiles]
    del tiles
    kernels.reset_launches()
    r = _volume_step(torch, tile_box, spec, lut_dev, arrays, static, cfg,
                     tiled, max_cells, log=log)
    total = time.time() - t_seg
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else 0.0
    seg_xzy, avg = r["seg_xzy"], r["avg"]
    if seg_xzy.shape != (spec.shape[0], spec.shape[2], spec.shape[1]) \
            or not bool(torch.isfinite(avg).all()):
        raise AssertionError("3D path output malformed")
    correct, matched = _accuracy_3d(torch, s3, spec, n_codes, seg_xzy,
                                    r["pred"], lut_class, r["n_cells"],
                                    max_cells)
    return {"stages": r["stages"], "total": total,
            "n_cells": r["n_cells"], "correct": correct, "matched": matched,
            "launches": launches, "peak_gib": peak}


def _b3_exact_columns(ncols: int, nmom: int, nchan: int) -> list:
    """The columns of a B3 table whose terms are integers: all but the
    channel sums (count, border, moments, aux histogram, 0/1 mask)."""
    return [c for c in range(ncols)
            if not 2 + nmom <= c < 2 + nmom + nchan]


def _agree_b3(torch, out_k, out_k2, out_p, nmom: int, nchan: int):
    """B3 against its twin: (max abs error, ok). The integer columns must
    be bitwise equal to the twin's and to a second launch's (out_k2); the
    channel sums, added in the card's atomic order, within 2^-16
    relative."""
    exact = _b3_exact_columns(out_k.shape[1], nmom, nchan)
    sums = slice(2 + nmom, 2 + nmom + nchan)
    rel = ((out_k[:, sums] - out_p[:, sums]).abs()
           / out_p[:, sums].abs().clamp(min=1.0))
    err = float((out_k - out_p).abs().max())
    ok = (bool(torch.equal(out_k[:, exact], out_p[:, exact]))
          and bool(torch.equal(out_k[:, exact], out_k2[:, exact]))
          and (nchan == 0 or float(rel.max()) <= 2.0 ** -16))
    return err, ok


def _depth_classes(torch, labels):
    """The 10-bit step's erosion-depth classes of a label image's cells:
    the number of cross erosions (up to 40) each pixel of the cells'
    interior survives, clamped to [0, 41), as flat int32."""
    from hiprfish_tpu_torch.ops import morphology as morph

    interior = labels > 0
    eroded, depth = interior, interior.to(torch.int32)
    for _ in range(AUX_CLASSES_10B - 2):
        eroded = morph.binary_erosion(eroded) & interior
        depth = depth + eroded
    return torch.clamp(depth, 0, AUX_CLASSES_10B - 1).reshape(-1) \
        .contiguous()


def _tile_labels(torch, spec, n_codes: int, dev):
    """A 3D tile's labels as segment_3d_tiled hands them to B3 and B4:
    (tile_x + 2 margin, Z, Y) int32, here the planted cells of the volume's
    first slab, ranked 1.. within it."""
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    tx = TILED_3D["tile_x"] + 2 * TILED_3D["margin"]
    tile = torch.empty((tx, SHAPE_3D[2], SHAPE_3D[1]), dtype=torch.int32,
                       device=dev)
    for z0 in range(0, SHAPE_3D[2], 10):
        zc = min(10, SHAPE_3D[2] - z0)
        tile[:, z0:z0 + zc] = s3.truth_chunk(spec, n_codes, z0, zc,
                                             dev)[0][:tx].permute(0, 2, 1)
    return torch.unique(tile, return_inverse=True)[1].to(torch.int32)


def _smooth_image(shape, seed: int):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(yy / 17.0) * np.cos(xx / 23.0) \
        + 0.005 * rng.randn(*shape)
    return img.astype(np.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1

    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.kernels import _build
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.ops import denoise, line_profile, segstats
    from hiprfish_tpu_torch.pipeline import fused
    from hiprfish_tpu_torch.utils import synthetic

    # 1. the card
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")

    # 2. build: the library and, beside it, phase 13's B6 instance
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_build.build),
                pool.submit(_build.build_lpcv3d, *DOMAIN_LPCV3D)]
        lib, lib3 = (j.result() for j in jobs)
    _build.load()
    print(f"phase 2 build: {time.time() - t0:.1f} s -> {lib}, {lib3}")
    for stem in ("nlm", "segstats", "lpcv3d"):
        for line in _build.ptxas_report(stem):
            print(f"phase 2 ptxas {stem}.cu: {line}")

    # 3. kernels vs plain at the main path's shapes
    layout = SEVEN_BIT
    cell_codes = synthetic.FLAGSHIP_CODES
    size = synthetic.FLAGSHIP_SHAPE[0]
    t0 = time.time()
    fov = synthetic.flagship_fov()
    print(f"phase 3 fixture: {size}^2 x {layout.n_channels} ch, "
          f"{len(cell_codes)} cells, built in {time.time() - t0:.1f} s")
    report = {}

    def yardsticks(ms, work, library, reps):
        """bound, share and library call of a kernel timed at ``ms``."""
        bound_ms, bound_by = bound(*work)
        library_ms = None if library is None else _time_ms(torch, library,
                                                           reps)
        lib_txt = "none" if library_ms is None else f"{library_ms:.3f} ms"
        text = (f"bound {bound_ms:.4f} ms ({bound_by}) share "
                f"{bound_ms / ms:.4f} library {lib_txt}")
        return {"ops": work[0], "bytes": work[1], "bound_ms": bound_ms,
                "bound_by": bound_by, "share": bound_ms / ms,
                "library_ms": library_ms}, text

    def check(name, kernel, plain, reps, plain_reps, work, library=None,
              phase=3, agree=None):
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        base = name.split("[")[0]
        err, ok = (_agree(torch, base, out_k, out_p) if agree is None
                   else agree(out_k, out_p))
        ms = _time_ms(torch, kernel, reps)
        plain_ms = _time_ms(torch, plain, plain_reps)
        yard, text = yardsticks(ms, work, library, reps)
        print(f"phase {phase} {name}: max_abs_err {err:.3e} "
              f"({TOL_TEXT[base]}) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms {text} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **yard}
        return out_k

    def check_b3(key, args, reps, plain_reps, work, library, phase=3):
        """B3 at one column set: check() with the integer columns held
        bitwise to the twin and to a second launch."""
        nmom = 5 if args[6] else 0
        nchan = 0 if args[1] is None else args[1].shape[1]
        return check(
            f"label_stats[{key}]", lambda: kernels.label_stats(*args),
            lambda: segstats.label_stats_table_plain(*args), reps,
            plain_reps, work, library, phase,
            agree=lambda out_k, out_p: _agree_b3(
                torch, out_k, kernels.label_stats(*args), out_p, nmom,
                nchan))

    smooth = torch.from_numpy(_smooth_image((size, size), 0)).to(dev)
    den = check("nlm", lambda: kernels.nlm(smooth, 0.02, 7, 11),
                lambda: denoise.denoise_nl_means_plain(smooth, 0.02, 7, 11),
                10, 3, kernel_work("nlm", h=size, w=size, pd=11))
    table2d = line_profile.line_table_2d(11, 9)
    check("lpcv2d", lambda: kernels.lpcv2d(den, table2d),
          lambda: line_profile.lp_cv_enhance_2d_plain(den, 11, 9), 10, 5,
          kernel_work("lpcv2d", h=size, w=size))

    labels = torch.from_numpy(fov["truth_labels"].astype(np.int32)).to(dev)
    flat = labels.reshape(-1)
    cube_flat = torch.cat([torch.from_numpy(a) for a in fov["stack"]], dim=2) \
        .to(dev).to(torch.bfloat16).reshape(flat.shape[0], -1)
    nseg = 2 * MAX_CELLS
    n_lab = int(((flat > 0) & (flat < nseg)).sum())
    # counts only (the seed-size filters, fill-holes ranks, 3D tiles); the
    # yardstick: one bincount of the labels
    check_b3("counts", (flat, None, None, None, nseg, 0, False, size, size),
             20, 10,
             kernel_work("label_stats", pixels=flat.numel(), labelled=n_lab,
                         ncols=2, row_bytes=0, segments=nseg),
             lambda: torch.bincount(flat, minlength=nseg))
    # counts + the 41-class erosion-depth histogram of the 10-bit step's
    # seeding (depth of the cells' interior after up to 40 erosions); the
    # yardstick: one bincount of label * 41 + class, the key made outside
    # the timing
    aux_flat = _depth_classes(torch, labels)
    aux_key = flat.to(torch.int64) * AUX_CLASSES_10B + aux_flat
    check_b3("aux41", (flat, None, aux_flat, None, nseg, AUX_CLASSES_10B,
                       False, size, size), 20, 5,
             kernel_work("label_stats", pixels=flat.numel(), labelled=n_lab,
                         ncols=2 + AUX_CLASSES_10B, row_bytes=0, px_bytes=4,
                         segments=nseg),
             lambda: torch.bincount(aux_key,
                                    minlength=AUX_CLASSES_10B * nseg))
    del aux_flat, aux_key
    # the 7-bit step's measurement set: the bf16 63-channel cube; the
    # yardstick: one index_add_ of the labelled pixels' f32 channel rows,
    # selected and widened outside the timing (it leaves out the count and
    # border columns)
    stats_args = (flat, cube_flat, None, None, nseg, 0, False, size, size)
    nchan = cube_flat.shape[1]
    sel = (flat > 0) & (flat < nseg)
    lab_sel, rows_sel = flat[sel], cube_flat[sel].to(torch.float32)
    check_b3("cube7b", stats_args, 10, 5,
             kernel_work("label_stats", pixels=flat.numel(),
                         labelled=lab_sel.numel(), ncols=2 + nchan,
                         row_bytes=2 * nchan, segments=nseg),
             lambda: torch.zeros((nseg, nchan), device=dev).index_add_(
                 0, lab_sel, rows_sel))
    del sel, lab_sel, rows_sel

    gen = torch.Generator(device="cpu").manual_seed(0)
    tbl = torch.rand(nseg, generator=gen).to(dev)
    # the yardstick: one gather from the table with row 0 set to 0 (the
    # labels lie in [0, nseg), so it is B4's function on these inputs)
    tbl0 = tbl.clone()
    tbl0[0] = 0.0
    check("label_lookup[2000^2]", lambda: kernels.label_lookup(labels, tbl),
          lambda: segstats.label_lookup_plain(labels, tbl), 20, 20,
          kernel_work("label_lookup", pixels=labels.numel(), segments=nseg),
          lambda: torch.index_select(tbl0, 0, flat))

    # 4. a small FOV: plain versions on the CPU vs kernels on the card
    cfg = SegmentationConfig()
    clf = load_classifier(FIXTURE)
    small = synthetic.make_fov(layout, [1 + (i * 7) % 127 for i in range(30)],
                               shape=(256, 256), seed=1,
                               laser_shifts=synthetic.FLAGSHIP_SHIFTS,
                               cell_axes=synthetic.FLAGSHIP_CELL_AXES)
    outs = []
    for d in (torch.device("cpu"), dev):
        arr, static = fused.classifier_from_numpy(clf, d)
        st = tuple(torch.from_numpy(a).to(d) for a in small["stack"])
        outs.append(fused.fov_step(st, arr, cfg, 64, static))
    cpu_r, gpu_r = outs
    n_c, n_g = int(cpu_r.n_cells), int(gpu_r.n_cells)
    seg_agree = float((cpu_r.segmentation
                       == gpu_r.segmentation.cpu()).float().mean())
    v = cpu_r.valid
    codes_eq = bool(torch.equal(cpu_r.code_idx[v], gpu_r.code_idx.cpu()[v]))
    print(f"phase 4 256^2 cpu vs gpu: n_cells {n_c} / {n_g}, segmentation "
          f"agreement {seg_agree:.6f}, code_idx equal {codes_eq}")
    if n_c != n_g or not codes_eq or seg_agree < 0.999:
        raise AssertionError("256^2 FOV: the card disagrees with the CPU")

    # 5. the main path at full size
    arrays, static = fused.classifier_from_numpy(clf, dev)
    stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
    torch.cuda.synchronize()
    step = lambda: fused.fov_step(stack, arrays, cfg, MAX_CELLS,  # noqa
                                  static)
    kernels.reset_launches()
    t0 = time.time()
    res = step()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = kernels.launch_counts()
    print(f"phase 5 first call {first_s:.2f} s, launches {launches}")
    missing = [k for k in PATH_2D if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by fov_step: {missing}")
    seg = res.segmentation.cpu().numpy()
    n_found = int(res.n_cells)
    if seg.shape != (size, size) or not bool(torch.isfinite(
            res.avgint).all()):
        raise AssertionError("fov_step output malformed")
    correct, total = _barcode_accuracy(
        seg, fov["truth_labels"], res.code_idx.cpu().numpy(), cell_codes,
        list(clf.codebook), layout, n_found, MAX_CELLS)
    acc = correct / max(total, 1)
    times, n_calls = [], [n_found]
    for _ in range(5):
        t0 = time.time()
        r = step()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1000)
        n_calls.append(int(r.n_cells))
    ms = float(np.median(times))
    print(f"phase 5 fov_step {size}^2: n_cells {n_found}, matched {total}, "
          f"accuracy {acc:.4f} ({correct}/{total}), {ms:.1f} ms/FOV "
          f"(median of 5; all {[round(t, 1) for t in times]}); n_cells of "
          f"the six calls {n_calls}")
    if total < 380 or acc < 0.99:
        raise AssertionError("accuracy below 0.99 or fewer than 380 cells")
    if len(set(n_calls)) != 1:
        raise AssertionError(f"fov_step: n_cells differs between calls "
                             f"{n_calls}")
    # the 7-bit FOV's host and device arrays are not used again
    del fov, stack, res, r, seg, labels, flat, cube_flat, stats_args, small, \
        outs, cpu_r, gpu_r

    # 6. the 3D fixture; B6 and B5 against their plain twins
    from hiprfish_tpu_torch.pipeline import segment3d
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    spec = s3.VolumeSpec(shape=SHAPE_3D, spacing=(36, 36, 52), seed=5)
    codes3 = list(range(1, 128))
    lut = np.stack([synthetic.barcode_spectrum(layout, c) for c in codes3])
    lut_dev = torch.from_numpy(lut.astype(np.float32)).to(dev)
    t0 = time.time()
    vol = s3.build_sum_volume(spec, len(codes3), lut_dev.sum(dim=1).cpu(),
                              seed=1, z_chunk=16, device=dev)
    torch.cuda.synchronize()
    print(f"phase 6 fixture: {SHAPE_3D} volume, {spec.n_cells} planted "
          f"cells, built in {time.time() - t0:.1f} s")
    # B6 on a 256 x 170 x 256 sub-volume (quick to repeat), then on the
    # whole volume, the shape segment_3d_tiled gives it: 2020 is no
    # multiple of the kernel's 16-plane x march nor of its 32-wide y tile,
    # so the whole volume also takes the partial last blocks
    sub = (vol[:256, :256, :] / vol.max()).permute(0, 2, 1).contiguous()
    check("lpcv3d", lambda: kernels.lpcv3d(sub, True),
          lambda: line_profile.lp_cv_enhance_3d_plain(
              sub, bf16=True, layout="xzy"), 5, 2,
          kernel_work("lpcv3d", voxels=sub.numel()), phase=6)
    del sub
    sub_report = report.pop("lpcv3d")
    vol_xzy = (vol / vol.max()).permute(0, 2, 1).contiguous()
    out_k = kernels.lpcv3d(vol_xzy, True)
    out_p, plain_vol_ms = _time_once(
        torch, lambda: line_profile.lp_cv_enhance_3d_plain(
            vol_xzy, bf16=True, layout="xzy"))
    err_vol, ok_vol = _agree(torch, "lpcv3d", out_k, out_p)
    del out_k, out_p
    torch.cuda.empty_cache()
    ms_vol = _time_ms(torch, lambda: kernels.lpcv3d(vol_xzy, True), 3)
    yard, text = yardsticks(ms_vol, kernel_work(
        "lpcv3d", voxels=vol_xzy.numel()), None, 0)
    print(f"phase 6 lpcv3d on the whole {tuple(vol_xzy.shape)} (X, Z, Y) "
          f"volume: max_abs_err {err_vol:.3e} ({TOL_TEXT['lpcv3d']}) "
          f"kernel {ms_vol:.3f} ms plain {plain_vol_ms:.3f} ms (one call) "
          f"{text} {'ok' if ok_vol else 'FAIL'}")
    if not ok_vol:
        raise AssertionError("lpcv3d: kernel disagrees with plain on the "
                             "whole volume")
    report["lpcv3d"] = {"max_abs_err": err_vol, "ms": ms_vol,
                        "plain_ms": plain_vol_ms, **yard,
                        "shape": list(vol_xzy.shape),
                        "subvolume": {"shape": [256, 170, 256],
                                      **sub_report}}
    del vol_xzy
    torch.cuda.empty_cache()
    lab_cm = s3.truth_chunk(spec, len(codes3), 78, 2, dev)[0] \
        .permute(2, 0, 1).contiguous().reshape(-1)
    img_cm = s3.channel_chunk_cm(spec, len(codes3), 78, 2, lut_dev, 1,
                                 torch.bfloat16).reshape(63, -1)
    # the yardstick: one index_add_ of the labelled voxels' f32 channel
    # rows, selected, transposed and widened outside the timing (counts
    # aside)
    sel = (lab_cm > 0) & (lab_cm < MAX_CELLS_3D)
    lab_sel = lab_cm[sel]
    rows_sel = img_cm[:, sel].T.to(torch.float32).contiguous()
    check("stats_cm", lambda: kernels.stats_cm(lab_cm, img_cm, MAX_CELLS_3D),
          lambda: segstats.stats_cm_plain(lab_cm, img_cm, MAX_CELLS_3D),
          10, 3,
          kernel_work("stats_cm", pixels=lab_cm.numel(),
                      labelled=lab_sel.numel(), ncols=1 + img_cm.shape[0],
                      row_bytes=2 * img_cm.shape[0], segments=MAX_CELLS_3D),
          lambda: torch.zeros((MAX_CELLS_3D, img_cm.shape[0]),
                              device=dev).index_add_(0, lab_sel, rows_sel),
          phase=6)
    del lab_cm, img_cm, sel, lab_sel, rows_sel

    # B3 (counts) and B4 on a 3D tile's labels as segment_3d_tiled hands
    # them over: (tile_x + 2 margin) x Z x Y, here the planted cells of the
    # volume's first slab ranked within it (the tile's seed markers cover
    # fewer voxels)
    tile = _tile_labels(torch, spec, len(codes3), dev)
    tx = tile.shape[0]
    tcap = TILED_3D["tile_cap"]
    tflat = tile.reshape(-1)
    n_tile = int((tflat > 0).sum())
    print(f"phase 6 3D tile labels {tuple(tile.shape)}: {int(tflat.max())} "
          f"cells, {n_tile} labelled voxels")
    check_b3("tile3d", (tflat, None, None, None, tcap, 0, False, tx,
                        tflat.numel() // tx), 10, 3,
             kernel_work("label_stats", pixels=tflat.numel(),
                         labelled=n_tile, ncols=2, row_bytes=0,
                         segments=tcap),
             lambda: torch.bincount(tflat, minlength=tcap), phase=6)
    ttbl = torch.rand(tcap, generator=gen).to(dev)
    ttbl0 = ttbl.clone()
    ttbl0[0] = 0.0
    check("label_lookup[tile3d]", lambda: kernels.label_lookup(tile, ttbl),
          lambda: segstats.label_lookup_plain(tile, ttbl), 10, 3,
          kernel_work("label_lookup", pixels=tflat.numel(), segments=tcap),
          lambda: torch.index_select(ttbl0, 0, tflat), phase=6)
    del tile, tflat, ttbl, ttbl0
    torch.cuda.empty_cache()

    # 7. a small volume: plain versions on the CPU vs kernels on the card
    small3 = _volume_stack([1, 9, 65, 127, 3, 5, 17, 33, 64],
                           (144, 96, 40)).sum(axis=3)
    cfg3 = SegmentationConfig(kmeans_iters=20)
    kw3 = dict(max_cells=64, tile_x=48, margin=32, tile_cap=64, bf16=True)
    seg_c, n_c3, _ = segment3d.segment_3d_tiled(torch.from_numpy(small3),
                                                cfg3, **kw3)
    seg_g, n_g3, _ = segment3d.segment_3d_tiled(
        torch.from_numpy(small3).to(dev), cfg3, **kw3)
    agree3 = float((seg_c == seg_g.cpu()).float().mean())
    print(f"phase 7 144x96x40 cpu vs gpu: n_cells {n_c3} / {n_g3}, "
          f"segmentation agreement {agree3:.6f}")
    if n_c3 != n_g3 or agree3 < 0.9999:
        raise AssertionError("144x96x40 volume: the card disagrees with "
                             "the CPU")

    # 8. the 3D volume path at full size
    del vol
    r3 = _volume_pass(torch, dev, spec, lut_dev, clf, cfg, TILED_3D,
                      MAX_CELLS_3D)
    launches3 = r3["launches"]
    print(f"phase 8 stages (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in r3["stages"].items())
        + f"; total {r3['total']:.2f} s; peak memory {r3['peak_gib']:.2f} "
        f"GiB; launches {launches3}")
    missing = [k for k in PATH_3D if launches3[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the 3D path: "
                             f"{missing}")
    n3, matched3, correct3 = r3["n_cells"], r3["matched"], r3["correct"]
    acc3 = correct3 / max(matched3, 1)
    print(f"phase 8 volume {SHAPE_3D}: n_cells {n3} (planted "
          f"{spec.n_cells}), matched {matched3}, accuracy {acc3:.4f} "
          f"({correct3}/{matched3})")
    if n3 != spec.n_cells or matched3 < 9300 or acc3 < 0.99:
        raise AssertionError("3D path: n_cells != 9408, or accuracy below "
                             "0.99, or fewer than 9300 matched cells")

    # 9. the 10-bit FOV; B3 at the 10-bit step's column set
    from hiprfish_tpu_torch.config import TEN_BIT
    from hiprfish_tpu_torch.pipeline import fused_ecoli, measure, segment2d

    del r3, spec, lut_dev
    torch.cuda.empty_cache()
    t0 = time.time()
    efov = synthetic.ecoli_fov()
    ecodes = synthetic.ECOLI_CODES
    esize = synthetic.ECOLI_SHAPE[0]
    print(f"phase 9 fixture: {esize}^2 x {TEN_BIT.n_channels} ch, "
          f"{len(ecodes)} cells, built in {time.time() - t0:.1f} s")
    elabels = torch.from_numpy(efov["truth_labels"]).to(dev)
    eflat = elabels.reshape(-1)
    ecube = torch.cat([torch.from_numpy(a) for a in efov["stack"]], dim=2) \
        .to(dev).to(torch.bfloat16).reshape(eflat.shape[0], -1)
    gen = torch.Generator(device="cpu").manual_seed(9)
    eaux = torch.randint(0, AUX_CLASSES_10B, eflat.shape, generator=gen,
                         dtype=torch.int32).to(dev)
    emask = (torch.rand(eflat.shape, generator=gen) > 0.3) \
        .to(torch.float32).to(dev)
    args10 = (eflat, ecube, eaux, emask, 2 * MAX_CELLS, AUX_CLASSES_10B,
              True, esize, esize)
    nchan10 = ecube.shape[1]
    # the yardstick as in phase 3: the labelled pixels' f32 channel rows
    esel = (eflat > 0) & (eflat < 2 * MAX_CELLS)
    elab_sel, erows_sel = eflat[esel], ecube[esel].to(torch.float32)
    check_b3("cols10b", args10, 10, 3, kernel_work(
        "label_stats", pixels=eflat.numel(), labelled=elab_sel.numel(),
        ncols=2 + 5 + nchan10 + AUX_CLASSES_10B + 1, row_bytes=2 * nchan10,
        px_bytes=8, segments=2 * MAX_CELLS),
        lambda: torch.zeros((2 * MAX_CELLS, nchan10), device=dev)
        .index_add_(0, elab_sel, erows_sel), phase=9)
    del eaux, emask, ecube, eflat, elabels, args10, esel, elab_sel, erows_sel

    # 10. a small 10-bit FOV: plain versions on the CPU vs kernels on the
    # card
    clf10 = load_classifier(FIXTURE_10B)
    small10 = synthetic.make_fov(
        TEN_BIT, [(i * 37) % 1023 + 1 for i in range(16)], shape=(256, 256),
        seed=2, laser_shifts=synthetic.ECOLI_SHIFTS,
        cell_axes=synthetic.ECOLI_CELL_AXES)
    outs10 = []
    for d in (torch.device("cpu"), dev):
        arr, st10 = fused.classifier_from_numpy(clf10, d)
        st = tuple(torch.from_numpy(a).to(d) for a in small10["stack"])
        outs10.append(fused_ecoli.fov_step_ecoli(st, arr, cfg, 256, st10))
    cpu_e, gpu_e = outs10
    n_ce, n_ge = int(cpu_e.n_cells), int(gpu_e.n_cells)
    agree_e = float((cpu_e.segmentation
                     == gpu_e.segmentation.cpu()).float().mean())
    v = cpu_e.valid
    codes_eq_e = bool(torch.equal(cpu_e.code_idx[v], gpu_e.code_idx.cpu()[v]))
    print(f"phase 10 256^2 10-bit cpu vs gpu: n_cells {n_ce} / {n_ge}, "
          f"segmentation agreement {agree_e:.6f}, code_idx equal "
          f"{codes_eq_e}")
    if n_ce != n_ge or not codes_eq_e or agree_e < 0.999:
        raise AssertionError("256^2 10-bit FOV: the card disagrees with the "
                             "CPU")

    # 11. the 10-bit step at full size
    arrays10, static10 = fused.classifier_from_numpy(clf10, dev)
    codebook10 = list(clf10.codebook)
    estack = tuple(torch.from_numpy(a).to(dev) for a in efov["stack"])
    etruth = efov["truth_labels"]
    del efov
    torch.cuda.synchronize()
    estep = lambda: fused_ecoli.fov_step_ecoli(  # noqa: E731
        estack, arrays10, cfg, MAX_CELLS, static10)
    kernels.reset_launches()
    t0 = time.time()
    eres = estep()
    torch.cuda.synchronize()
    efirst_s = time.time() - t0
    launches10 = kernels.launch_counts()
    print(f"phase 11 first call {efirst_s:.2f} s, launches {launches10}")
    missing = [k for k in PATH_ECOLI if launches10[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by fov_step_ecoli: "
                             f"{missing}")
    eseg = eres.segmentation.cpu().numpy()
    en_found = int(eres.n_cells)
    if eseg.shape != (esize, esize) or not bool(torch.isfinite(
            eres.avgint).all()):
        raise AssertionError("fov_step_ecoli output malformed")
    ecorrect, etotal = _barcode_accuracy(
        eseg, etruth, eres.code_idx.cpu().numpy(), ecodes, codebook10,
        TEN_BIT, en_found, MAX_CELLS)
    eacc = ecorrect / max(etotal, 1)
    etimes, en_calls = [], [en_found]
    for _ in range(5):
        t0 = time.time()
        er = estep()
        torch.cuda.synchronize()
        etimes.append((time.time() - t0) * 1000)
        en_calls.append(int(er.n_cells))
    ems = float(np.median(etimes))
    print(f"phase 11 fov_step_ecoli {esize}^2: n_cells {en_found}, matched "
          f"{etotal}, accuracy {eacc:.4f} ({ecorrect}/{etotal}), "
          f"{ems:.1f} ms/FOV (median of 5; all "
          f"{[round(t, 1) for t in etimes]}); n_cells of the six calls "
          f"{en_calls}")
    if etotal < 380 or eacc < 0.99:
        raise AssertionError("10-bit step: accuracy below 0.99 or fewer "
                             "than 380 cells")
    if len(set(en_calls)) != 1:
        raise AssertionError(f"fov_step_ecoli: n_cells differs between "
                             f"calls {en_calls}")
    del eres, er, eseg

    # 12. the host engine once at full size
    hstages = {}
    torch.cuda.synchronize()
    t0 = time.time()
    hres = segment2d.segment_ecoli(estack, cfg, MAX_CELLS)
    torch.cuda.synchronize()
    hstages["segment_ecoli"] = time.time() - t0
    t0 = time.time()
    _, hnorm = measure.measure_fov(hres.segmentation, hres.registered,
                                   hres.n_cells, MAX_CELLS)
    hstages["measure_fov"] = time.time() - t0
    t0 = time.time()
    hfeats = fused_ecoli.violet_features(torch.from_numpy(hnorm).to(dev),
                                         static10[1])
    hpred, _ = fused.classify_device(
        hfeats, arrays10["check_heads"], static10[6],
        arrays10.get("scaler_mean"), arrays10.get("scaler_scale"),
        arrays10["train_features"], arrays10["train_labels"],
        *static10[:6])
    hpred = np.concatenate([[0], hpred.cpu().numpy()])
    hstages["classify"] = time.time() - t0
    hn = int(hres.n_cells)
    hcorrect, htotal = _barcode_accuracy(
        hres.segmentation.cpu().numpy(), etruth, hpred, ecodes, codebook10,
        TEN_BIT, hn, MAX_CELLS)
    hacc = hcorrect / max(htotal, 1)
    print(f"phase 12 host engine {esize}^2: n_cells {hn}, matched {htotal}, "
          f"accuracy {hacc:.4f} ({hcorrect}/{htotal}); stages (s): "
          + ", ".join(f"{k} {v:.2f}" for k, v in hstages.items())
          + f"; total {sum(hstages.values()):.2f} s")
    if htotal < 380 or hacc < 0.99:
        raise AssertionError("10-bit host engine: accuracy below 0.99 or "
                             "fewer than 380 cells")

    # 13. B1, B2 and B6 beyond the main paths' configurations
    domains = {}

    def domain(name, base, kernel, plain, reps):
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = _agree(torch, base, out_k, out_p)
        ms = _time_ms(torch, kernel, reps)
        plain_ms = _time_ms(torch, plain, 1)
        print(f"phase 13 {name}: max_abs_err {err:.3e} ({TOL_TEXT[base]}) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"{'ok' if ok else 'FAIL'}")
        domains[name] = {"max_abs_err": err, "ok": ok, "ms": ms,
                         "plain_ms": plain_ms}

    hh, ww, patch, pd = DOMAIN_NLM
    img13 = torch.from_numpy(_smooth_image((hh, ww), 13)).to(dev)
    domain(f"nlm patch {patch} pd {pd} {hh}x{ww}", "nlm",
           lambda: kernels.nlm(img13, 0.02, patch, pd),
           lambda: denoise.denoise_nl_means_plain(img13, 0.02, patch, pd), 3)
    for p2, phi in DOMAIN_LPCV2D:
        tab = line_profile.line_table_2d(p2, phi)
        domain(f"lpcv2d ({p2}, {phi}) {hh}x{ww}", "lpcv2d",
               lambda: kernels.lpcv2d(img13, tab),
               lambda: line_profile.lp_cv_enhance_2d_plain(img13, p2, phi),
               10)
    vol13 = torch.from_numpy(_volume_stack([1, 9, 65, 127], (40, 36, 24))
                             .sum(axis=3)).to(dev)
    vol13 = (vol13 / vol13.max()).permute(0, 2, 1).contiguous()
    for bf16 in (True, False):
        domain(f"lpcv3d {DOMAIN_LPCV3D} {'bf16' if bf16 else 'f32'} "
               f"{'x'.join(map(str, vol13.shape))}", "lpcv3d",
               lambda: kernels.lpcv3d(vol13, bf16, *DOMAIN_LPCV3D),
               lambda: line_profile.lp_cv_enhance_3d_plain(
                   vol13, *DOMAIN_LPCV3D, bf16=bf16, layout="xzy"), 10)
    if not all(d["ok"] for d in domains.values()):
        raise AssertionError("a kernel disagrees with its plain twin beyond "
                             "the main paths' configurations")

    by_path = {"fov_step": (launches, PATH_2D),
               "volume_3d": (launches3, PATH_3D),
               "fov_step_ecoli": (launches10, PATH_ECOLI)}
    entries = []
    for key in REPORT_ORDER:
        k = key.split("[")[0]
        entries.append({
            "name": key, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": sum(c[k] * (k in p) for c, p in by_path.values()),
            "launches_by_path": {name: c[k] * (k in p)
                                 for name, (c, p) in by_path.items()},
            **report[key]})
    print(json.dumps({"kernels": entries, "domains": domains}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
