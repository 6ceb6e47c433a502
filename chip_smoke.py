#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (hiprfish_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the script exits
non-zero and prints no result:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the six CUDA kernels from csrc/ (one nvcc per source) and, in
     parallel with them, B6's instances for the configurations (7, 5, 6),
     (21, 5, 4) and (29, 3, 4) of phase 13; print the build time and
     ptxas's registers and spills of B1, B2, B3/B4/B5 and B6;
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
     than the main paths' and time both, each with its bound: B1 at patch
     7, pd 80 (its global-memory geometry), B2 at (7, 5), (15, 12) and
     just past its former caps, (131, 5) and (11, 129) (a 96 x 160
     image), B6 at (7, 5, 6) in bf16 and f32, and at (21, 5, 4) in f32
     and (29, 3, 4) in bf16, whose plane rings need the 16-wide blocks (a
     40 x 24 x 36 volume);
 14. run the four command lines at their default flags (max_cells 4096,
     device cuda) in a temporary directory, twice each (cold, warm): the
     2000^2 10-bit FOV's five .npy planes through cli.measure -c F (the
     fused engine: B3 and B4 must launch) and cli.classify with the
     1023-class classifier, and the 2000^2 7-bit FOV's four planes through
     cli.measure_multispecies (the LP-CV engine: B1 and B2 must launch)
     and cli.classify_spectra with the 127-code classifier. The calls are
     read back from the written artifacts (_seg.npy with _cell_ids.txt, or
     the barcode and label columns of _cell_information.csv) and must
     reach 399 and 389 matched cells at accuracy 1.0, the JAX engines'
     counts on these FOVs, with the same artifacts in both calls; print
     each call's wall seconds and each measure call's peak device memory.
     The planes and truth labels are kept (moved, not copied) for 18;
 15. the biofilm paths (B1 and B2 on the card): (a) segment_lpcv(...,
     "biofilm") at bkg_min_size=200, epithelial_disk_radius=6 on the CPU
     (plain versions) and on the card, on the 192^2 seed-5 FOV (equal
     n_cells, agreement >= 0.999 for the labels, the adjacency labels and
     the epithelial mask) and on it with two bright slabs planted
     (agreement >= 0.999 for the epithelial mask, non-empty on both, and
     for the labels and the adjacency labels paired one to one on the
     pixels more than 19 px from the slabs: the slabs' own labels are
     LP-CV speckle that the denoised image's last bits reseed and
     renumber, on the CPU as well; so the CPU run's B1 and B2 inputs and
     its three floods are also replayed on the card, which must give the
     CPU's outputs: B1 and B2 within TOL, each flood's labels on >= 0.999
     of the pixels); (b) cli.biofilm -d 2 at its default flags on the
     2000^2 7-bit FOV's four planes with a probe design of the 127-code
     classifier's codes, twice (cold, warm): 395 cells (the JAX engine's
     count), >= 390 of the 400 planted cells matched, barcode accuracy
     >= 0.99 read back from _cell_information.csv, B1 and B2 launched
     once per call, the same _seg.npy, _adjacency_seg.npy and CSVs in both
     calls; print each stage's seconds, the debris count and the peak
     device memory; (c) the 2000^2 FOV with two slabs planted (all rows of
     columns 0-399, rows 1400-1999 of columns 1200-1999) through
     segment_lpcv(..., "biofilm") at the default configuration twice: a
     non-empty epithelial mask, identical labels and masks; (d)
     cli.biofilm -z 1 2 on per-laser (Z = 4, 2000, 2000, C_l) .npy stacks
     of the FOV (per-z weights 0.7, 1.0, 1.0, 0.7, fresh noise per z,
     lasers 2-4 shifted in x, y and z): per slice the bar of (b) but the
     count, and B1 and B2 launched once per slice. Z = 4 (of a real
     stack's tens of slices) is the only cut, for the time limit;
 16. the volumetric biofilm analysis (the untiled 3D engine: B6, B3, B4):
     (a) segment_3d on the 96 x 64 x 32 volume of phase 7's helper with
     lasers 2-4 rolled, on the CPU (plain versions) and on the card, both
     in bf16 LP-CV mode: equal n_cells and registration shifts, label
     agreement >= 0.9999, B6, B3 and B4 launched on the card; (b) B6 on
     one microscope tile's normalised channel sum (1040 x 170 x 550
     (X, Z, Y), bf16), B3 counts with 32768 segments and B4 with a
     32768-entry table over the tile's 97.24 M labels, each against its
     plain twin (B3 and B4 bitwise, B6 within TOL) with bound and library
     call; (c) cli.biofilm -d 3 at its default flags on one tile of the
     flagship volume cut to Z = 110 (VolumeSpec((1040, 550, 110),
     (36, 36, 52), seed 5), 840 planted cells, 127 codes; the cut keeps
     the stacks and artifacts within the machine's 45 GiB of disk writes),
     written as four (110, 1040, 550, C_l) float32 .npy stacks with lasers
     2-4 rolled in x, y and z: the shifts found undo the rolls, B6, B3 and
     B4 launch, barcode accuracy >= 0.99 over the matched cells from the
     artifacts, every planted cell of a code whose summed spectrum is at
     least DIM_SPECTRUM x the median found (one label covers half its
     voxels), the bvox
     header, CSV rows and identification shape right, peak device memory
     below 60 GiB, and a second segment_3d_from_sum of the written channel
     sum gives the same labels; print the stages' seconds, the bytes
     written and the peak.
 17. classifier training (no kernel of its own; its classifiers then feed
     B1-B4): (a) train_check_heads (3 heads of the 7-bit fixture's rows,
     n = 5000, 60 steps) and train_classifier (the 7-bit fixture recipe,
     60 steps) on the CPU and on the card from the same inputs, initial
     parameters and permutations: parameters within 2e-3, check bits on
     >= 99.9 % of the rows equal, the same kNN matrix; (b) the committed
     fixtures' recipes (tools/make_torch_port_fixture.py, rebuilt by the
     port's utils/synthetic: 7-bit 127 codes x 50 rows, 10-bit 1023 codes
     x 200 rows = 204,600 x 126 with the violet derivative, 300 steps)
     retrained on the card: kNN matrices byte-identical to the fixtures',
     check bits as the JAX-trained heads' on >= 99.9 % of the rows; then
     fov_step and fov_step_ecoli on the 2000^2 FOVs with the port-trained
     classifiers: the n_cells of phases 5 and 11, accuracy >= 0.99 over
     >= 380 matched cells, B1-B4 launched; (c) cli.train at the
     reference's defaults (-s 2000, 1000 Adam steps per head) on a
     1023-code reference folder written by utils/synthetic
     (cells_per_code=60, seed 0): -v violet_derivative (2,046,000 rows x
     126, 6 heads, an 8,184-row kNN matrix; self-accuracy on the measured
     means >= 0.99) and -v fret_biofilm_7b (254,000 positives + 254,000
     negatives, scaler; self-accuracy recorded); each artifact loads
     through models/artifacts.load_classifier; print each call's
     synchronised stages, peak device memory and self-accuracy.
 18. cli.workflow at its defaults (device cuda, max_cells 4096): the
     measure -> classify -> collect loop over a table of FOVs in this warm
     process, each run in a temporary directory with its launches counted
     from zero: (a) --family ecoli, mode R, on two 2000^2 single-code
     10-bit FOVs (make_fov(TEN_BIT, [enc] * 400, ...) for the codes 260
     and 186 of ECOLI_CODES, 2 and 5 set bits) with the committed 1023-class
     classifier linked in under the ecoli convention's name (SPC 200):
     _results.csv has 2 rows, each NCells >= 380 and ErrorRate <= 0.01,
     ErrorRateUpperLimit T or F, B3 and B4 launched; (b) mode M on phase
     14's 400-code FOV (its planes linked in): 1023 abundance rows, FOV1
     summing to the _cell_ids.txt lines and NCells, >= 380 planted codes
     counted, >= 0.99 of the counted cells on planted codes; (c)
     --family multispecies on phase 14's 7-bit FOV with the 127-code
     classifier linked in under the 7-bit convention's name: 389 matched
     at 1.0 from _cell_information.csv, B1 and B2 launched; (d) (a) again
     on the same directory: no stage re-runs (only collect), no artifact's
     mtime changes, no kernel launches. Print each run's RunLog summary
     (measure, classify and collect seconds, in total and per call), (d)'s
     seconds and the bytes the phase wrote. (a)'s planes are its only
     large writes; a linked file is never written again.

At the end the script's total seconds and the card's line are printed,
then a JSON object with one entry per kernel (its launches on each path,
errors, times, bound and library call) and the other phases' results
(training and the workflow among them); the last line is {"ok": true,
"device": {...}}. The script imports neither jax
nor the JAX package hiprfish_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
    # B2: the phi-term mean's f32 summation order (up to phi ulps of 1
    # past phi = 16, see lpcv2d_tol)
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
# the kernels the measure command lines launch: the fused 10-bit engine
# and the LP-CV engine
PATH_CLI_MEASURE = ("label_stats", "label_lookup")
PATH_CLI_MULTISPECIES = ("nlm", "lpcv2d")
# the laser names of the per-laser planes the command lines read
LASERS_10B = ("405", "488", "514", "561", "633")
LASERS_7B = ("488", "514", "561", "633")
# the JAX engines' matched cells on the 2000^2 FOVs at max_cells 4096
CLI_MATCHED_10B = 399
CLI_MATCHED_7B = 389
# phase 18: cli.workflow. (a)'s two single-code reference FOVs (from
# ECOLI_CODES, of 2 and 5 set bits), the SPC the committed fixtures were
# trained at, and their names under the reference's classifier
# conventions (io/tables.reference_clf_path_from_row for the 10-bit
# family, workflows/driver.run_multispecies_workflow for the 7-bit one)
WORKFLOW_ENCS = (260, 186)
# (a)'s bar on each FOV's ErrorRate (a FOV without errors reports 1 /
# NCells, its upper limit)
WORKFLOW_MAX_ERROR = 0.01
WORKFLOW_SPC_10B = 200
WORKFLOW_SPC_7B = 50
WORKFLOW_CLF_10B = (f"reference_simulate_{WORKFLOW_SPC_10B}_excitation_"
                    "adjusted_normalized_violet_derivative_umap_transform"
                    ".npz")
WORKFLOW_CLF_7B = (f"reference_simulate_{WORKFLOW_SPC_7B}_interaction_"
                   "simulated_excitation_adjusted_normalized_umap_transform_"
                   "biofilm_7b.npz")
# phase 15: the kernels of the biofilm paths; the 192^2 FOV's codes
# (tests/test_biofilm_and_3d.py); the JAX engine's segment count on the
# 2000^2 FOV (hiprfish_tpu.pipeline.segment2d.segment_lpcv, biofilm, on the
# CPU); the z-stack's per-z weights, per-laser (x, y, z) shifts and the
# slices the command line analyses
PATH_BIOFILM = ("nlm", "lpcv2d")
# the 192^2 slab FOV's slabs (all rows of columns [0, 40), rows [150, end)
# of columns [120, end)) and the margin past which 15a holds its labels:
# NL-means reaches pd + patch // 2 = 14 px, LP-CV 5 more
SLABS_192 = (40, 150, 120)
SLAB_MARGIN = 19
BIOFILM_CODES_192 = (1, 9, 65, 127, 34, 88)
BIOFILM_CELLS_2000 = 395
ZSTACK_WEIGHTS = (0.7, 1.0, 1.0, 0.7)
ZSTACK_SHIFTS = ((0, 0, 0), (3, -2, 1), (-2, 4, 0), (1, 1, -1))
ZSTACK_SLICES = (1, 2)
# phase 16: the kernels of the volumetric analysis; one microscope tile of
# the 3D volume (tools/bench3d.py:137-138 cuts it into 2 x 4 tiles of
# (1040, 550, 170)), the shape of 16b; 16c's tile, cut to Z = 110 (two of
# its three cell layers: 840 of 1,260 planted cells): the machine takes
# at most 45 GiB of disk writes per call, and the full tile's stacks and
# artifacts are 48 GiB; the rolls of lasers 1-3 of 16a and 16c (x, y, z;
# laser 0 stays), which the registration must undo; the seed filter's
# segments; the peak device memory 16c must stay below
PATH_BIOFILM_3D = ("label_stats", "label_lookup", "lpcv3d")
TILE_SHAPE = (1040, 550, 170)
TILE_SHAPE_CLI = (1040, 550, 110)
VOLUME_ROLLS = ((0, 0, 0), (3, -2, 1), (-2, 4, 0), (1, 1, -1))
SEED_SEGMENTS = 32768
TILE_PEAK_GIB = 60.0
# 16c's stacks add uniform noise to each of the 63 channels, so the
# channel sum's background is ~0.95; codes 8, 16 and 24 sum their spectra
# to 2.4-4.0 (the median code 27.4), and the untiled engine's log10
# KMeans background mask leaves their cells out, in the JAX package as in
# the port (ROADMAP §C). 16c must find every planted cell of a code whose
# summed spectrum is at least DIM_SPECTRUM x the median
DIM_SPECTRUM = 0.2
# the order of the kernels line: B3 once per column set, B4 once per shape
REPORT_ORDER = ("nlm", "lpcv2d", "label_stats[counts]", "label_stats[aux41]",
                "label_stats[cube7b]", "label_stats[cols10b]",
                "label_stats[tile3d]", "label_stats[volume3d]",
                "label_lookup[2000^2]", "label_lookup[tile3d]",
                "label_lookup[volume3d]", "stats_cm", "lpcv3d",
                "lpcv3d[tile]")
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
# B2 per pixel at (11, 9): 9 x 10 x 2 min/max, 9 ratios x 4, the mean 9,
# the 25 compare-exchanges of an optimal 9-input sorting network x 2 (the
# kernel's pruned selection network takes 26), the quartile combine 6
# (ops_lpcv2d for any stencil)
OPS_LPCV2D = 9 * 10 * 2 + 9 * 4 + 9 + 25 * 2 + 6
# B6 per voxel at (11, 9, 9): 72 x 10 x 2 min/max, 72 ratios x 4, the mean
# 72, the 640 compare-exchanges of the quartile network x 2, the combine
# 10 (ops_lpcv3d for any configuration)
OPS_LPCV3D = 72 * 10 * 2 + 72 * 4 + 72 + 640 * 2 + 10
# the 3D volume of tools/bench3d.py and its segmentation settings
SHAPE_3D = (2020, 2020, 170)
MAX_CELLS_3D = 16384
TILED_3D = dict(tile_x=360, margin=64, tile_cap=8192, scan_cap=32)
# the configurations of phase 13: (h, w, patch, pd) of B1, the (patch,
# phi) of B2 and the (patch, theta, phi) of B6
DOMAIN_NLM = (96, 160, 7, 80)
DOMAIN_LPCV2D = ((7, 5), (15, 12), (131, 5), (11, 129))
# (patch, theta, phi, bf16)
DOMAIN_LPCV3D = ((7, 5, 6, True), (7, 5, 6, False), (21, 5, 4, False),
                 (29, 3, 4, True))


# phase 17c: simulations per code of cli.train's default
TRAIN_SPC = 2000


# the fewest compare-exchanges known to sort n = 0 .. 17 values (Knuth,
# TAOCP vol. 3, 5.3.4, and later searches; proven optimal up to n = 12)
BEST_SORT = (0, 0, 1, 3, 5, 9, 12, 16, 19, 25, 29, 35, 39, 45, 51, 56, 60, 71)


def _network_ops(n: int) -> int:
    """2 ops per compare-exchange of the fewest known to put the
    interpolated quartiles' ranks of n values in place: the pruned
    selection network, or a whole sorting network where BEST_SORT knows a
    smaller one."""
    from hiprfish_tpu_torch.ops import line_profile as lp

    (lo25, hi25, _), (lo75, hi75, _) = lp.quartile_ranks(n)
    n_cx = len(lp.selection_network(n, (lo25, hi25, lo75, hi75)))
    if n < len(BEST_SORT):
        n_cx = min(n_cx, BEST_SORT[n])
    return 2 * n_cx


def ops_lpcv2d(patch: int = 11, phi: int = 9) -> int:
    """B2's operations per pixel: phi x (patch - 1) x 2 min/max, phi
    ratios x 4, the mean phi, the quartile network, the combine 6."""
    return phi * (patch - 1) * 2 + phi * 4 + phi + _network_ops(phi) + 6


def ops_lpcv3d(patch: int = 11, theta: int = 9, phi: int = 9) -> int:
    """B6's operations per voxel over its (theta - 1) phi orientations, as
    ops_lpcv2d, the combine 10."""
    n = (theta - 1) * phi
    return n * (patch - 1) * 2 + n * 4 + n + _network_ops(n) + 10


def lpcv2d_tol(phi: int) -> float:
    """B2's tolerance against its twin: 1e-6, or phi ulps of 1 (the
    phi-term mean of ratios in [0, 1] summed in another order)."""
    return max(TOL["lpcv2d"], phi * 2.0 ** -24)


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
        return px * ops_lpcv2d(a.get("patch", 11), a.get("phi", 9)), 8 * px
    if name == "lpcv3d":
        cfg = (a.get("patch", 11), a.get("theta", 9), a.get("phi", 9))
        return a["voxels"] * ops_lpcv3d(*cfg), 8 * a["voxels"]
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


def _artifact_calls(sample: str, table: bool):
    """(segmentation, codebook, code index per label) read back from a
    classified FOV's artifacts: _seg.npy with _cell_ids.txt (label i + 1
    on line i), or the barcode (column 67: 63 features, 4 check bits) and
    label (column 69) columns of _cell_information.csv."""
    seg = np.load(f"{sample}_seg.npy")
    if table:
        with open(f"{sample}_cell_information.csv") as f:
            rows = [line.split(",") for line in f.read().splitlines()]
        by_label = {int(r[69]): r[67] for r in rows}
        codes = [by_label[i] for i in range(1, len(rows) + 1)]
    else:
        with open(f"{sample}_cell_ids.txt") as f:
            codes = f.read().split()
    return seg, ["-"] + codes, np.arange(len(codes) + 1)


def _cli_pass(torch, kernels, measure_main, classify_main, measure_argv,
              classify_argv, sample, table, path, phase_name):
    """One command-line pair twice (cold, warm) in the current directory.
    The measure call's launches are counted from zero in the cold call.
    Returns (seconds per call, launches, artifacts of the warm call, peak
    device memory of each measure call in GiB) and fails unless both
    calls wrote the same segmentation and calls."""
    seconds, peaks, launches, prev = {}, {}, None, None
    for turn in ("cold", "warm"):
        if turn == "cold":
            kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        measure_main(measure_argv)
        torch.cuda.synchronize()
        seconds[f"measure {turn}"] = time.time() - t0
        peaks[f"measure {turn}"] = torch.cuda.max_memory_allocated() / 2**30
        if turn == "cold":
            launches = kernels.launch_counts()
        t0 = time.time()
        classify_main(classify_argv)
        torch.cuda.synchronize()
        seconds[f"classify {turn}"] = time.time() - t0
        seg, codebook, idx = _artifact_calls(sample, table)
        if prev is not None and (not np.array_equal(seg, prev[0])
                                 or codebook != prev[1]):
            raise AssertionError(f"{phase_name}: the warm call wrote other "
                                 f"artifacts than the cold call")
        prev = (seg, codebook, idx)
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by {phase_name}: "
                             f"{missing}")
    return seconds, launches, prev, peaks


def _cli_phase(torch, kernels, fixture_10b: str, fixture_7b: str,
               keep: str) -> dict:
    """Phase 14: the four command lines on the 2000^2 FOVs, in a temporary
    directory that is removed afterwards. The FOVs' planes and truth
    labels are moved into ``keep`` for phase 18 (no second write)."""
    from hiprfish_tpu_torch.cli import classify as cli_classify
    from hiprfish_tpu_torch.cli import classify_spectra as cli_spectra
    from hiprfish_tpu_torch.cli import measure as cli_measure
    from hiprfish_tpu_torch.cli import measure_multispecies as cli_ms
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
    from hiprfish_tpu_torch.utils import synthetic

    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            runs = (
                ("measure", synthetic.ecoli_fov, TEN_BIT, LASERS_10B,
                 synthetic.ECOLI_CODES, "ecoli_enc_5", False,
                 cli_measure.main, ["-c", "F"], cli_classify.main,
                 lambda s: [f"{s}_avgint.csv", "-rf", fixture_10b],
                 PATH_CLI_MEASURE, CLI_MATCHED_10B),
                ("measure_multispecies", synthetic.flagship_fov, SEVEN_BIT,
                 LASERS_7B, synthetic.FLAGSHIP_CODES, "flagship", True,
                 cli_ms.main, [], cli_spectra.main,
                 lambda s: ["-i", f"{s}_avgint_norm.csv", "-r", fixture_7b],
                 PATH_CLI_MULTISPECIES, CLI_MATCHED_7B),
            )
            for (name, make, layout, lasers, cell_codes, sample, table,
                 m_main, m_flags, c_main, c_argv, path, want) in runs:
                fov = make()
                names = [f"{sample}_{laser}.npy" for laser in lasers]
                for fname, plane in zip(names, fov["stack"]):
                    np.save(fname, plane)
                truth = fov["truth_labels"]
                del fov
                seconds, launches, (seg, codebook, idx), peaks = _cli_pass(
                    torch, kernels, m_main, c_main, ["-i", *names, *m_flags],
                    c_argv(sample), sample, table, path, f"cli.{name}")
                n_found = len(codebook) - 1
                if seg.shape != truth.shape or int(seg.max()) != n_found:
                    raise AssertionError(f"cli.{name}: artifacts malformed")
                correct, matched = _barcode_accuracy(
                    seg, truth, idx, cell_codes, codebook, layout, n_found,
                    n_found + 1)
                acc = correct / max(matched, 1)
                print(f"phase 14 cli.{name} {seg.shape[0]}^2: n_cells "
                      f"{n_found}, matched {matched}, accuracy {acc:.4f} "
                      f"({correct}/{matched}) from the artifacts; seconds "
                      + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
                      + "; peak GiB " + ", ".join(f"{k} {v:.3f}" for k, v
                                                  in peaks.items())
                      + f"; launches {launches}")
                if matched != want or correct != matched:
                    raise AssertionError(
                        f"cli.{name}: {correct}/{matched} matched cells "
                        f"correct, expected {want}/{want}")
                out[name] = {"n_cells": n_found, "matched": matched,
                             "accuracy": acc, "seconds": seconds,
                             "peak_gib": peaks, "launches": launches}
                for fname in names:
                    os.rename(fname, os.path.join(keep, fname))
                np.save(os.path.join(keep, f"{sample}_truth.npy"), truth)
                for fname in os.listdir("."):
                    os.remove(fname)
        finally:
            os.chdir(cwd)
    return out


def _plant_slabs(stack, band: int, row0: int, col0: int):
    """Copies of the planes with two bright slabs, each +0.5 x the plane's
    maximum: all rows of columns [0, band), and rows [row0, end) of
    columns [col0, end)."""
    out = []
    for plane in stack:
        p = plane.copy()
        add = 0.5 * p.max()
        p[:, :band] += add
        p[row0:, col0:] += add
        out.append(p)
    return out


def _slab_region(shape, band: int, row0: int, col0: int, margin: int):
    """Boolean mask of the pixels farther than ``margin`` (Chebyshev) from
    the slabs of _plant_slabs."""
    h, w = shape
    keep = np.ones((h, w), bool)
    keep[:, :band + margin] = False
    keep[max(row0 - margin, 0):, max(col0 - margin, 0):] = False
    return keep


def _matched_agreement(a, b, region) -> float:
    """Share of the ``region``'s pixels on which the label images ``a`` and
    ``b`` agree once their labels are paired one to one: background with
    background, then the other pairs greedily by their overlap there,
    largest first. Label ids may differ; a split, merge or moved boundary
    costs its pixels."""
    a = a[region].astype(np.int64)
    b = b[region].astype(np.int64)
    pairs, cnt = np.unique((a << 32) | b, return_counts=True)
    pa, pb = pairs >> 32, pairs & 0xFFFFFFFF
    good = int(cnt[(pa == 0) & (pb == 0)].sum())
    used_a, used_b = {0}, {0}
    for i in np.argsort(-cnt, kind="stable"):
        x, y = int(pa[i]), int(pb[i])
        if x not in used_a and y not in used_b:
            used_a.add(x)
            used_b.add(y)
            good += int(cnt[i])
    return good / max(a.size, 1)


def _recorder(fn, log: list):
    """``fn``, appending (args, kwargs, output) of every call to ``log``;
    ``fn`` itself is its __wrapped__."""
    def rec(*a, **kw):
        out = fn(*a, **kw)
        log.append((a, kw, out))
        return out
    rec.__wrapped__ = fn
    return rec


def _replay_on(torch, dev, stages, log) -> dict:
    """Each recorded call again on ``dev`` with the recorded inputs: B1 and
    B2 held to their outputs within TOL, a flood's labels held to >= 0.999
    of its pixels. {"<key> <i>": {"max_abs_err" or "agreement", "ok"}}."""
    def to_dev(x):
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    out = {}
    for mod, attr, key in stages:
        for i, (a, kw, want) in enumerate(log[key]):
            got = getattr(mod, attr)(*map(to_dev, a),
                                     **{k: to_dev(v) for k, v in kw.items()})
            got = got.cpu()
            if key == "flood":
                agree = float((got == want).float().mean())
                out[f"{key} {i}"] = {"agreement": agree, "ok": agree >= 0.999}
            else:
                err = float((got - want).abs().max())
                out[f"{key} {i}"] = {"max_abs_err": err,
                                     "ok": err <= TOL[key]}
    return out


def _write_probe_design(path: str, codebook) -> None:
    """A probe design with one taxon per code of the classifier."""
    with open(path, "w") as f:
        f.write("target_taxon,code\n")
        f.writelines(f"{1000 + i},{c}\n" for i, c in enumerate(codebook))


def _biofilm_table(sample: str):
    """(codebook, code index per label, cell types) from the biofilm
    _cell_information.csv (the label and cell_barcode columns)."""
    import csv

    with open(f"{sample}_cell_information.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    by_label = {int(r["label"]): r for r in rows}
    codes = [by_label[i]["cell_barcode"] for i in range(1, len(rows) + 1)]
    types = [by_label[i]["type"] for i in range(1, len(rows) + 1)]
    return ["-"] + codes, np.arange(len(codes) + 1), types


def _digests(paths) -> dict:
    """{path: sha256 of its bytes}."""
    import hashlib

    out = {}
    for p in sorted(paths):
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def _biofilm_cpu_vs_card(torch, dev) -> dict:
    """Phase 15a: the biofilm engine on the CPU (plain versions) and on
    ``dev`` (B1, B2) at 192^2, on the plain FOV and the slab FOV."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.pipeline import segment2d
    from hiprfish_tpu_torch.utils import synthetic

    out = {}
    # 15a. CPU (plain versions) against the card (B1, B2) at 192^2. On the
    # plain FOV every label is held. On the slab FOV the slabs' flat
    # plateaus seed LP-CV speckle that the last bits of the denoised image
    # reseed (uniform noise of +-2e-6 on it moves the CPU's own count from
    # 64 to 63 or 65, tools/biofilm_slab_witness.py), which renumbers the
    # sequential labels. There the labels and adjacency labels are held,
    # paired one to one, on the pixels more than SLAB_MARGIN px from the
    # slabs, the epithelial mask on every pixel, and the stages that work
    # inside the slabs on the CPU's own inputs: the CPU run's B1 and B2
    # inputs and its three floods (cells, adjacency, epithelial area) are
    # recorded and replayed on the card, which must give the CPU's outputs
    plain = synthetic.make_fov(SEVEN_BIT, list(BIOFILM_CODES_192),
                               shape=(192, 192), seed=5,
                               cell_axes=(7.0, 12.0))["stack"]
    cfg_small = SegmentationConfig(bkg_min_size=200, epithelial_disk_radius=6)
    away = _slab_region((192, 192), *SLABS_192, SLAB_MARGIN)
    stages = ((segment2d.dn, "denoise_nl_means_auto", "nlm"),
              (segment2d.lp, "lp_cv_enhance_2d", "lpcv2d"),
              (segment2d.ws, "watershed", "flood"))
    for name, stack in (("plain", plain),
                        ("slab", _plant_slabs(plain, *SLABS_192))):
        log = {key: [] for _, _, key in stages}
        for mod, attr, key in stages:
            setattr(mod, attr, _recorder(getattr(mod, attr), log[key]))
        try:
            cpu_r = segment2d.segment_lpcv(
                tuple(torch.from_numpy(a) for a in stack), None, cfg_small,
                128, "biofilm")
        finally:
            for mod, attr, _ in stages:
                setattr(mod, attr, getattr(mod, attr).__wrapped__)
        gpu_r = segment2d.segment_lpcv(
            tuple(torch.from_numpy(a).to(dev) for a in stack), None,
            cfg_small, 128, "biofilm")
        agree = {k: float((getattr(cpu_r, k) == getattr(gpu_r, k).cpu())
                          .float().mean())
                 for k in ("segmentation", "adjacency", "epithelial")}
        paired = {k: _matched_agreement(getattr(cpu_r, k).numpy(),
                                        getattr(gpu_r, k).cpu().numpy(), away)
                  for k in ("segmentation", "adjacency")}
        replay = _replay_on(torch, dev, stages, log)
        n_c, n_g = int(cpu_r.n_cells), int(gpu_r.n_cells)
        epi_px = [int(cpu_r.epithelial.sum()), int(gpu_r.epithelial.sum())]
        print(f"phase 15a biofilm 192^2 {name} cpu vs gpu: n_cells {n_c} / "
              f"{n_g}, agreement {agree}, paired agreement more than "
              f"{SLAB_MARGIN} px from the slabs {paired}, epithelial px "
              f"{epi_px}; the CPU's stage inputs replayed on the card "
              f"{replay}")
        held = ([agree[k] >= 0.999 for k in agree] + [n_c == n_g]
                if name == "plain" else
                [paired[k] >= 0.999 for k in paired]
                + [agree["epithelial"] >= 0.999, 0 not in epi_px])
        held += [r["ok"] for r in replay.values()]
        if not all(held):
            raise AssertionError(f"biofilm 192^2 {name}: the card disagrees "
                                 f"with the CPU")
        out[f"192 {name} cpu vs gpu"] = {"n_cells": [n_c, n_g],
                                         "agreement": agree,
                                         "paired_agreement_away": paired,
                                         "epithelial_px": epi_px,
                                         "stages_replayed": replay}
    return out


def _biofilm_phase(torch, kernels, fixture_7b: str, dev) -> dict:
    """Phase 15: the biofilm engine on the CPU against the card at 192^2
    (15a), cli.biofilm -d 2 on the 2000^2 FOV twice (15b), the epithelial
    branch at full width twice (15c) and cli.biofilm -z 1 2 on a Z = 4
    stack of the 2000^2 FOV (15d)."""
    from hiprfish_tpu_torch.cli import biofilm as cli_biofilm
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import biofilm, segment2d
    from hiprfish_tpu_torch.utils import synthetic

    out = _biofilm_cpu_vs_card(torch, dev)
    fov = synthetic.flagship_fov()
    truth = fov["truth_labels"]
    codebook = list(load_classifier(fixture_7b).codebook)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        measure = biofilm.measure_biofilm_images_2d
        try:
            _write_probe_design("probes.csv", codebook)
            flags = ["-p", "probes.csv", "-r", fixture_7b]
            # 15b. cli.biofilm -d 2 at full width, cold and warm
            os.mkdir("fov")
            for laser, plane in zip(LASERS_7B, fov["stack"]):
                np.save(f"fov/flagship_{laser}.npy", plane)
            calls = []
            for turn in ("cold", "warm"):
                stages = {}
                biofilm.measure_biofilm_images_2d = (
                    lambda *a, **kw: measure(*a, timings=stages, **kw))
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()
                t0 = time.time()
                cli_biofilm.main(["fov", *flags, "-d", "2"])
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = kernels.launch_counts()
                seg = np.load("fov/flagship_seg.npy")
                codes, idx, types = _biofilm_table("fov/flagship")
                n_found = len(codes) - 1
                correct, matched = _barcode_accuracy(
                    seg, truth, idx, synthetic.FLAGSHIP_CODES, codes,
                    SEVEN_BIT, n_found, n_found + 1)
                acc = correct / max(matched, 1)
                digest = _digests(
                    ["fov/flagship_seg.npy", "fov/flagship_adjacency_seg.npy"]
                    + [f"fov/{n}" for n in os.listdir("fov")
                       if n.endswith(".csv")])
                call = {"n_cells": n_found, "matched": matched,
                        "accuracy": acc, "debris": types.count("debris"),
                        "seconds": wall, "stages": stages,
                        "launches": launches,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
                print(f"phase 15b cli.biofilm -d 2 {turn} {seg.shape[0]}^2: "
                      f"n_cells {n_found}, matched {matched}, accuracy "
                      f"{acc:.4f} ({correct}/{matched}) from the artifacts, "
                      f"debris {call['debris']}; {wall:.2f} s, stages (s) "
                      + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
                      + f"; peak {call['peak_gib']:.2f} GiB; launches "
                      f"{launches}")
                if (n_found != BIOFILM_CELLS_2000 or matched < 390
                        or acc < 0.99):
                    raise AssertionError(
                        f"cli.biofilm -d 2: {n_found} cells, {correct}/"
                        f"{matched} matched correct; expected "
                        f"{BIOFILM_CELLS_2000} cells, >= 390 matched at "
                        f">= 0.99")
                if any(launches[k] != 1 for k in PATH_BIOFILM):
                    raise AssertionError(f"cli.biofilm -d 2: B1 and B2 must "
                                         f"launch once, got {launches}")
                calls.append((digest, call))
            differ = [p for p in calls[0][0]
                      if calls[0][0][p] != calls[1][0].get(p)]
            if differ:
                raise AssertionError(f"cli.biofilm -d 2: the warm call wrote "
                                     f"other artifacts than the cold call: "
                                     f"{differ}")
            out["cli.biofilm -d 2"] = {"cold": calls[0][1],
                                       "warm": calls[1][1]}
            biofilm.measure_biofilm_images_2d = measure

            # 15c. the epithelial branch at full width, twice
            slabs = _plant_slabs(fov["stack"], 400, 1400, 1200)
            stack = tuple(torch.from_numpy(a).to(dev) for a in slabs)
            del slabs
            runs = []
            for _ in range(2):
                t0 = time.time()
                r = segment2d.segment_lpcv(stack, None, SegmentationConfig(),
                                           4096, "biofilm")
                torch.cuda.synchronize()
                runs.append((r, time.time() - t0))
            (r1, s1), (r2, s2) = runs
            same = all(torch.equal(getattr(r1, k), getattr(r2, k)) for k in
                       ("segmentation", "adjacency", "epithelial"))
            epi = int(r1.epithelial.sum())
            print(f"phase 15c epithelial branch 2000^2: n_cells "
                  f"{int(r1.n_cells)} / {int(r2.n_cells)}, epithelial px "
                  f"{epi}, calls identical {same}; {s1:.2f} s, {s2:.2f} s")
            if epi == 0 or not same:
                raise AssertionError("epithelial branch: empty or not "
                                     "repeatable")
            out["epithelial 2000"] = {"n_cells": int(r1.n_cells),
                                      "epithelial_px": epi,
                                      "seconds": [s1, s2]}
            del stack, runs, r, r1, r2
            torch.cuda.empty_cache()

            # 15d. cli.biofilm -z on a Z = 4 stack (the depth cut)
            os.mkdir("zstack")
            rng = np.random.default_rng(15)
            t0 = time.time()
            for laser, plane, shift in zip(LASERS_7B, fov["stack"],
                                           ZSTACK_SHIFTS):
                vol = np.stack([
                    w * plane + rng.random(plane.shape, np.float32)
                    * np.float32(0.02 * plane.mean()) for w in ZSTACK_WEIGHTS])
                vol = np.roll(vol, (shift[2], shift[0], shift[1]), (0, 1, 2))
                np.save(f"zstack/zs_{laser}.npy", vol.astype(np.float32))
                del vol
            build_s = time.time() - t0
            del fov
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.time()
            cli_biofilm.main(["zstack", *flags, "-z",
                              *map(str, ZSTACK_SLICES)])
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            slices = {}
            for z in ZSTACK_SLICES:
                seg, codes, idx = _artifact_calls(f"zstack/zs_z_{z}", True)
                n_found = len(codes) - 1
                correct, matched = _barcode_accuracy(
                    seg, truth, idx, synthetic.FLAGSHIP_CODES, codes,
                    SEVEN_BIT, n_found, n_found + 1)
                acc = correct / max(matched, 1)
                slices[z] = {"n_cells": n_found, "matched": matched,
                             "accuracy": acc}
                print(f"phase 15d z {z}: n_cells {n_found}, matched "
                      f"{matched}, accuracy {acc:.4f} ({correct}/{matched})")
                if matched < 390 or acc < 0.99:
                    raise AssertionError(f"cli.biofilm -z slice {z}: "
                                         f"{correct}/{matched}")
            print(f"phase 15d cli.biofilm -z {list(ZSTACK_SLICES)} on "
                  f"{len(ZSTACK_WEIGHTS)} x 2000^2 x 63: {wall:.2f} s (stacks "
                  f"written in {build_s:.1f} s), peak {peak:.2f} GiB, "
                  f"launches {launches}")
            if any(launches[k] != len(ZSTACK_SLICES) for k in PATH_BIOFILM):
                raise AssertionError("cli.biofilm -z: B1 and B2 must launch "
                                     "once per slice")
            out["cli.biofilm -z"] = {"slices": slices, "seconds": wall,
                                     "peak_gib": peak, "launches": launches}
        finally:
            biofilm.measure_biofilm_images_2d = measure
            os.chdir(cwd)
    return out


def _volume_cpu_vs_card(torch, kernels, dev) -> dict:
    """Phase 16a: segment_3d on the 96 x 64 x 32 volume of _volume_stack
    with lasers 1-3 rolled by VOLUME_ROLLS, on the CPU (plain versions) and
    on ``dev`` (B6, B3, B4), both in bf16 LP-CV mode."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.pipeline import segment3d

    cube = _volume_stack([1, 9, 65, 127, 3, 5, 17, 33, 64], (96, 64, 32))
    blocks = [np.ascontiguousarray(np.roll(cube[..., lo:hi], r, (0, 1, 2)))
              for (lo, hi), r in zip(SEVEN_BIT.blocks, VOLUME_ROLLS)]
    out = {}
    for d in (torch.device("cpu"), dev):
        shifts = []
        kernels.reset_launches()
        seg, n, _, _ = segment3d.segment_3d(
            [torch.from_numpy(b) for b in blocks], SegmentationConfig(), 64,
            bf16=True, device=d, shifts=shifts)
        _sync(torch, d)
        out[d.type] = (seg.cpu(), n, shifts, kernels.launch_counts())
    (seg_c, n_c, sh_c, _), (seg_g, n_g, sh_g, launches) = out["cpu"], \
        out["cuda"]
    agree = float((seg_c == seg_g).float().mean())
    print(f"phase 16a 96x64x32 segment_3d cpu vs gpu: n_cells {n_c} / {n_g}, "
          f"agreement {agree:.6f}, shifts {sh_c} / {sh_g}; launches on the "
          f"card {launches}")
    if n_c != n_g or agree < 0.9999 or sh_c != sh_g:
        raise AssertionError("96x64x32 segment_3d: the card disagrees with "
                             "the CPU")
    missing = [k for k in PATH_BIOFILM_3D if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by segment_3d: "
                             f"{missing}")
    return {"n_cells": [n_c, n_g], "agreement": agree, "shifts": sh_c,
            "launches": launches}


def _planted_found(torch, s3, spec, n_codes: int, seg_xzy, n_found: int):
    """(num planted cells,) bool: does one found label cover at least half
    of the planted cell's voxels."""
    m = n_found + 1
    counts = torch.zeros((spec.n_cells + 1) * m, dtype=torch.int64,
                         device=seg_xzy.device)
    for z0 in range(0, spec.shape[2], 10):
        zc = min(10, spec.shape[2] - z0)
        truth = s3.truth_chunk(spec, n_codes, z0, zc, seg_xzy.device)[0]
        seg = seg_xzy[:, z0:z0 + zc, :].permute(0, 2, 1).to(torch.int64)
        counts += torch.bincount((truth.to(torch.int64) * m + seg)
                                 .reshape(-1), minlength=counts.numel())
    counts = counts.reshape(spec.n_cells + 1, m)[1:].cpu().numpy()
    return counts[:, 1:].max(axis=1) * 2 >= counts.sum(axis=1)


def _fill_tile_stacks(torch, spec, lut_dev, outs) -> None:
    """Fill the per-laser (Z, X, Y, C_l) float32 arrays ``outs`` (in
    memory or memory-mapped) with the 63-channel volume of ``spec``, made
    on the card a few z-planes at a time (synthetic3d.channel_chunk_cm,
    seed 1), laser l rolled by VOLUME_ROLLS[l] in (x, y, z)."""
    from hiprfish_tpu_torch.config import SEVEN_BIT
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    z = spec.shape[2]
    zc = 4
    for z0 in range(0, z, zc):
        n = min(zc, z - z0)
        slab = s3.channel_chunk_cm(spec, lut_dev.shape[0], z0, n, lut_dev,
                                   1).permute(1, 2, 3, 0)
        for out, (lo, hi), (rx, ry, rz) in zip(outs, SEVEN_BIT.blocks,
                                               VOLUME_ROLLS):
            out[(np.arange(z0, z0 + n) + rz) % z] = torch.roll(
                slab[..., lo:hi], (rx, ry), (1, 2)).cpu().numpy()


def _write_tile_stacks(torch, spec, lut_dev, folder: str) -> int:
    """The tile's stacks (_fill_tile_stacks) as '{folder}/tile_<laser>.npy',
    streamed to memory-mapped files. Returns the bytes written."""
    from hiprfish_tpu_torch.config import SEVEN_BIT

    x, y, z = spec.shape
    outs = [np.lib.format.open_memmap(
        f"{folder}/tile_{laser}.npy", mode="w+", dtype=np.float32,
        shape=(z, x, y, hi - lo))
        for laser, (lo, hi) in zip(LASERS_7B, SEVEN_BIT.blocks)]
    _fill_tile_stacks(torch, spec, lut_dev, outs)
    nbytes = 0
    for out in outs:
        out.flush()
        nbytes += out.nbytes
    del outs
    return nbytes


def _volume_cli_phase(torch, kernels, fixture_7b: str, dev,
                      lut_dev) -> dict:
    """Phase 16c: cli.biofilm -d 3 on one microscope tile of the 3D volume,
    in a temporary directory that is removed afterwards."""
    from hiprfish_tpu_torch.cli import biofilm as cli_biofilm
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import segment3d
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    spec = s3.VolumeSpec(shape=TILE_SHAPE_CLI, spacing=(36, 36, 52),
                         seed=5)
    codebook = list(load_classifier(fixture_7b).codebook)
    n_codes = lut_dev.shape[0]
    lut_class = np.array([codebook.index(SEVEN_BIT.code_str(c + 1))
                          for c in range(n_codes)])
    x, y, z = TILE_SHAPE_CLI
    cwd = os.getcwd()
    measure = segment3d.measure_biofilm_images_3d
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            free = os.statvfs(".")
            print(f"phase 16c scratch: "
                  f"{free.f_bavail * free.f_frsize / 1e9:.1f} GB free")
            _write_probe_design("probes.csv", codebook)
            os.mkdir("tile")
            t0 = time.time()
            in_bytes = _write_tile_stacks(torch, spec, lut_dev, "tile")
            build_s = time.time() - t0
            inputs = set(os.listdir("tile"))
            stages, shifts = {}, []
            segment3d.measure_biofilm_images_3d = (
                lambda *a, **kw: measure(*a, timings=stages, shifts=shifts,
                                         **kw))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.time()
            cli_biofilm.main(["tile", "-p", "probes.csv", "-r", fixture_7b,
                              "-d", "3"])
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            segment3d.measure_biofilm_images_3d = measure
            written = {n: os.path.getsize(f"tile/{n}")
                       for n in os.listdir("tile") if n not in inputs}
            seg = np.load("tile/tile_seg.npy")
            codes, _, types = _biofilm_table("tile/tile")
            n_found = len(codes) - 1
            head = np.fromfile("tile/tile_raw_image.bvox", "<i4", 4).tolist()
            ident_shape = np.load("tile/tile_identification.npy",
                                  mmap_mode="r").shape
            pred = np.array([0] + [codebook.index(c) for c in codes[1:]])
            seg_xzy = torch.from_numpy(seg).to(dev).permute(0, 2, 1)
            correct, matched = _accuracy_3d(torch, s3, spec, n_codes, seg_xzy,
                                            pred, lut_class, n_found,
                                            n_found + 1)
            found = _planted_found(torch, s3, spec, n_codes, seg_xzy,
                                   n_found)
            del seg_xzy
            acc = correct / max(matched, 1)
            # the same channel sum (the raw-image volume, Fortran order)
            # through the engine again, in memory
            raw = np.fromfile("tile/tile_raw_image.bvox", "<f4",
                              offset=16).reshape(z, y, x).transpose(2, 1, 0)
            t0 = time.time()
            seg2, n2, _ = segment3d.segment_3d_from_sum(
                [torch.from_numpy(np.ascontiguousarray(raw)).to(dev)],
                SegmentationConfig(), 4096)
            torch.cuda.synchronize()
            again_s = time.time() - t0
            same = n2 == n_found and np.array_equal(seg2.cpu().numpy(), seg)
            del seg2, raw
        finally:
            segment3d.measure_biofilm_images_3d = measure
            os.chdir(cwd)
    want = [tuple(-v for v in r) for r in VOLUME_ROLLS]
    spectrum = lut_dev.sum(dim=1).cpu().numpy()
    node_code = s3.node_codes(spec, n_codes)
    dim = spectrum[node_code] < DIM_SPECTRUM * np.median(spectrum)
    missed = sorted({int(c) + 1 for c in node_code[~found]})
    print(f"phase 16c cli.biofilm -d 3 on {TILE_SHAPE_CLI}: n_cells "
          f"{n_found} (planted {spec.n_cells}), matched {matched}, accuracy "
          f"{acc:.4f} ({correct}/{matched}) from the artifacts; planted "
          f"cells found {int(found.sum())}, of the {int((~dim).sum())} with "
          f"a summed spectrum >= {DIM_SPECTRUM} x the median "
          f"{int(found[~dim].sum())}, codes of the missed cells {missed}; "
          f"debris "
          f"{types.count('debris')}; shifts {shifts} (want {want}); "
          f"{wall:.2f} s, stages (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; stacks {in_bytes / 1e9:.2f} GB written in {build_s:.1f} s; "
          f"artifacts {sum(written.values()) / 1e9:.2f} GB {written}; peak "
          f"{peak:.2f} GiB; launches {launches}; bvox header {head}, "
          f"identification {ident_shape}; repeat segment_3d_from_sum "
          f"{again_s:.2f} s, same labels and n_cells {same}")
    if shifts != want:
        raise AssertionError(f"cli.biofilm -d 3: shifts {shifts}, planted "
                             f"{want}")
    missing = [k for k in PATH_BIOFILM_3D if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by cli.biofilm -d 3: "
                             f"{missing}")
    if acc < 0.99 or not found[~dim].all():
        raise AssertionError(f"cli.biofilm -d 3: {correct}/{matched} matched "
                             f"correct, {int(found[~dim].sum())} of the "
                             f"{int((~dim).sum())} bright planted cells "
                             f"found; expected >= 0.99 and all")
    if (head != [x, y, z, 1] or seg.max() != n_found
            or ident_shape != (x, y, z, 3)):
        raise AssertionError("cli.biofilm -d 3: artifacts malformed")
    if peak >= TILE_PEAK_GIB:
        raise AssertionError(f"cli.biofilm -d 3: peak {peak:.2f} GiB")
    if not same:
        raise AssertionError("cli.biofilm -d 3: a second segment_3d_from_sum "
                             "of the channel sum gave other labels")
    return {"n_cells": n_found, "matched": matched, "accuracy": acc,
            "planted": spec.n_cells, "found": int(found.sum()),
            "bright": int((~dim).sum()), "bright_found":
            int(found[~dim].sum()), "missed_codes": missed,
            "debris": types.count("debris"), "shifts": shifts,
            "seconds": wall, "stages": stages, "stacks_bytes": in_bytes,
            "stacks_seconds": build_s, "artifact_bytes": written,
            "peak_gib": peak, "launches": launches,
            "repeat_seconds": again_s}


def _check_bits(torch, clf, spectra, dev):
    """(n, H) check-bit calls of ``clf``'s heads on ``spectra`` (the head
    part of fused.classify_device), as numpy."""
    import torch.nn.functional as F

    from hiprfish_tpu_torch.pipeline import fused

    arrays, _ = fused.classifier_from_numpy(clf, dev)
    x = torch.from_numpy(np.ascontiguousarray(spectra, np.float32)).to(dev)
    n_ch = clf.n_channels
    scaled = x[:, :n_ch]
    if clf.scaler_mean is not None:
        scaled = (scaled - arrays["scaler_mean"]) / arrays["scaler_scale"]
    wmax = arrays["check_heads"][0].d_in
    cols = []
    with torch.no_grad():
        for head, (lo, hi) in zip(arrays["check_heads"], clf.check_blocks):
            xin = scaled[:, lo:hi] if hi <= n_ch else x[:, lo:hi]
            cols.append(head(F.pad(xin, (0, wmax - (hi - lo)))) > 0)
    return torch.stack(cols, dim=1).cpu().numpy()


def _train_cpu_vs_card(torch, dev) -> dict:
    """17a: train_check_heads (3 heads of the 7-bit fixture's rows, n =
    5000, 60 steps) and train_classifier (the 7-bit fixture recipe, 60
    steps) on the CPU and on ``dev`` from the same inputs, initial
    parameters and permutations."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, ClassifierConfig
    from hiprfish_tpu_torch.models import classifier as mclf
    from hiprfish_tpu_torch.models import train as mtrain
    from hiprfish_tpu_torch.utils import synthetic

    spectra, strs = synthetic.fixture_training_set(SEVEN_BIT, 50)
    checks = mtrain.check_bits_for_codes(SEVEN_BIT, strs)
    idx = np.random.RandomState(1).choice(len(spectra), 5000, replace=False)
    blocks = SEVEN_BIT.blocks[:3]
    x = np.zeros((3, 5000, 23), np.float32)
    for h, (lo, hi) in enumerate(blocks):
        x[h, :, :hi - lo] = spectra[idx, lo:hi]
    x = torch.from_numpy(x)
    y = torch.from_numpy(np.ascontiguousarray(checks[idx, :3].T))
    gen = torch.Generator().manual_seed(0)
    init = mclf.init_check_heads(gen, 3, 23, 64)
    perms = torch.stack([torch.randperm(5000, generator=gen)
                         for _ in range(3)])
    p_cpu = mclf.train_check_heads(x, y, init, perms, 60, 3e-3)
    p_dev = mclf.train_check_heads(
        x.to(dev), y.to(dev), {k: v.to(dev) for k, v in init.items()},
        perms.to(dev), 60, 3e-3)
    p_err = max(float((p_cpu[k] - p_dev[k].cpu()).abs().max())
                for k in p_cpu)
    with torch.no_grad():
        l_cpu = mclf.CheckHeads.from_params(p_cpu, "cpu")(x)
        l_dev = mclf.CheckHeads.from_params(p_dev, dev)(x.to(dev)).cpu()
    l_err = float((l_cpu - l_dev).abs().max())
    h_agree = float(((l_cpu > 0) == (l_dev > 0)).float().mean())

    n_heads, n = 4, len(spectra)
    draws = (mclf.init_check_heads(gen, n_heads, 23, 64),
             torch.stack([torch.randperm(n, generator=gen)
                          for _ in range(n_heads)]))
    cfg = ClassifierConfig(check_train_steps=60)
    c_cpu, c_dev = (mclf.train_classifier(
        None, SEVEN_BIT, spectra, strs, checks, cfg, device=d,
        head_draws=draws) for d in ("cpu", dev))
    same = (c_cpu.train_features.tobytes() == c_dev.train_features.tobytes()
            and c_cpu.train_labels.tobytes() == c_dev.train_labels.tobytes())
    c_agree = float((_check_bits(torch, c_cpu, spectra, "cpu")
                     == _check_bits(torch, c_dev, spectra, dev))
                    .all(axis=1).mean())
    c_err = max(float(np.abs(a[k] - b[k]).max())
                for a, b in zip(c_cpu.check_params, c_dev.check_params)
                for k in a)
    print(f"phase 17a train_check_heads 3 x 5000 rows, 60 steps, cpu vs "
          f"card: max parameter difference {p_err:.3e} (tol 2e-3), logits "
          f"{l_err:.3e}, check-bit agreement {h_agree:.6f}; "
          f"train_classifier 7-bit 6350 rows: kNN matrix equal {same}, "
          f"heads {c_err:.3e}, check-bit agreement on the rows "
          f"{c_agree:.6f}")
    if p_err > 2e-3 or h_agree < 0.999 or not same or c_agree < 0.999:
        raise AssertionError("17a: the card's training disagrees with "
                             "the CPU's")
    return {"heads_max_param_diff": p_err, "heads_max_logit_diff": l_err,
            "heads_check_agreement": h_agree, "knn_equal": same,
            "classifier_max_param_diff": c_err,
            "classifier_check_agreement": c_agree}


def _train_recipes(torch, dev):
    """17b (training): the committed fixtures' recipes retrained by the
    port on ``dev`` (tools/make_torch_port_fixture.py: 7-bit 127 codes x
    50 rows, 10-bit 1023 codes x 200 rows with the violet derivative,
    300 steps each); each kNN matrix must be the fixture's, byte for byte,
    and the heads' check bits on the rows must agree with the JAX-trained
    heads' on >= 99.9 % of them. Returns ({tag: classifier}, report)."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT, ClassifierConfig
    from hiprfish_tpu_torch.models import classifier as mclf
    from hiprfish_tpu_torch.models import train as mtrain
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.utils import synthetic

    dev = torch.device(dev)
    clfs, report = {}, {}
    for tag, layout, spc, fixture in (("7b", SEVEN_BIT, 50, FIXTURE),
                                      ("10b", TEN_BIT, 200, FIXTURE_10B)):
        spectra, strs = synthetic.fixture_training_set(layout, spc)
        checks = mtrain.check_bits_for_codes(layout, strs)
        _sync(torch, dev)
        t0 = time.perf_counter()
        clf = mclf.train_classifier(
            torch.Generator(dev).manual_seed(0), layout, spectra, strs,
            checks, ClassifierConfig(check_train_steps=300),
            violet_derivative=layout is TEN_BIT, device=dev)
        _sync(torch, dev)
        secs = time.perf_counter() - t0
        fix = load_classifier(fixture)
        same = (clf.train_features.tobytes() == fix.train_features.tobytes()
                and clf.train_labels.tobytes() == fix.train_labels.tobytes())
        got = _check_bits(torch, clf, spectra, dev)
        want = _check_bits(torch, fix, spectra, dev)
        agree = float((got == want).all(axis=1).mean())
        truth = checks[:, :got.shape[1]] > 0.5
        acc = float((got == truth).all(axis=1).mean())
        print(f"phase 17b train {tag} {spectra.shape[0]} x "
              f"{spectra.shape[1]}, 300 steps: {secs:.2f} s, kNN matrix "
              f"{clf.train_features.shape} equal to the fixture's {same}; "
              f"check bits agree with the JAX-trained heads on {agree:.6f} "
              f"of the rows (right on {acc:.6f})")
        if not same or agree < 0.999:
            raise AssertionError(f"17b: the port-trained {tag} classifier "
                                 "departs from the fixture")
        clfs[tag] = clf
        report[tag] = {"rows": int(spectra.shape[0]), "seconds": secs,
                       "knn_equal": same, "check_agreement": agree,
                       "check_accuracy": acc}
    return clfs, report


def _trained_steps(torch, kernels, dev, trained: dict, n_found: int,
                   en_found: int) -> dict:
    """17b (steps): fov_step on the 2000^2 7-bit FOV and fov_step_ecoli on
    the 2000^2 10-bit FOV with the port-trained classifiers: the n_cells of
    phases 5 and 11 (the committed fixtures'), barcode accuracy >= 0.99
    over >= 380 matched cells, B1-B4 launched (counts set to 0 just before
    each step and read just after)."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT, \
        SegmentationConfig
    from hiprfish_tpu_torch.pipeline import fused, fused_ecoli
    from hiprfish_tpu_torch.utils import synthetic

    cfg = SegmentationConfig()
    out = {}
    for name, make, tag, layout, codes, path, want in (
            ("fov_step", synthetic.flagship_fov, "7b", SEVEN_BIT,
             synthetic.FLAGSHIP_CODES, PATH_2D, n_found),
            ("fov_step_ecoli", synthetic.ecoli_fov, "10b", TEN_BIT,
             synthetic.ECOLI_CODES, PATH_ECOLI, en_found)):
        fov = make()
        arrays, static = fused.classifier_from_numpy(trained[tag], dev)
        stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
        step = fused.fov_step if tag == "7b" else fused_ecoli.fov_step_ecoli
        kernels.reset_launches()
        res = step(stack, arrays, cfg, MAX_CELLS, static)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        n = int(res.n_cells)
        correct, total = _barcode_accuracy(
            res.segmentation.cpu().numpy(), fov["truth_labels"],
            res.code_idx.cpu().numpy(), codes, list(trained[tag].codebook),
            layout, n, MAX_CELLS)
        del fov, stack, res, arrays
        acc = correct / max(total, 1)
        print(f"phase 17b {name} 2000^2 with the port-trained {tag} "
              f"classifier: n_cells {n} (with the fixture {want}), matched "
              f"{total}, accuracy {acc:.4f} ({correct}/{total}), launches "
              f"{launches}")
        missing = [k for k in path if launches[k] == 0]
        if missing:
            raise AssertionError(f"17b {name}: kernels not launched: "
                                 f"{missing}")
        if n != want:
            raise AssertionError(f"17b {name}: n_cells {n}, {want} with "
                                 "the fixture")
        if total < 380 or acc < 0.99:
            raise AssertionError(f"17b {name}: accuracy below 0.99 or "
                                 "fewer than 380 matched cells")
        out[name] = {"n_cells": n, "matched": total, "accuracy": acc,
                     "launches": launches}
    return out


def _self_accuracy(torch, clf, folder: str, dev) -> tuple[float, int]:
    """(share, count) of the reference folder's measured code means that
    ``clf`` calls as their own code (tests/test_train_builders.py's rule;
    7-bit classifiers: the 10-bit codes with bit 6 clear, channels 32-94,
    as their 7-bit codes, over the codes the classifier knows)."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT, \
        convert_code_to_7b
    from hiprfish_tpu_torch.models import train as mtrain
    from hiprfish_tpu_torch.models.classifier import classify

    stats = mtrain.load_reference_stats(folder)
    seven = clf.layout_name == SEVEN_BIT.name
    encs, want = [], []
    for e in sorted(stats):
        code = TEN_BIT.code_str(e)
        if seven:
            if code[6] != "0":
                continue
            code = convert_code_to_7b(code)
        if code in clf.codebook:
            encs.append(e)
            want.append(code)
    means = np.stack([stats[e][0] for e in encs]).astype(np.float32)
    if seven:
        means = means[:, 32:95]
    means = means / np.maximum(means.max(axis=1, keepdims=True), 1e-12)
    codes = classify(clf, means, device=dev)[0]
    return float(np.mean([c == w for c, w in zip(codes, want)])), len(want)


def _train_cli_phase(torch, dev, spc: int = TRAIN_SPC,
                     device_flag: str = "cuda") -> dict:
    """17c: cli.train at the reference's defaults (-s 2000, 1000 steps per
    head) on a 1023-code synthetic reference folder (60 cells per code,
    seed 0): -v violet_derivative (1023 x spc rows, 6 heads, 8 prototypes
    per code) and -v fret_biofilm_7b (127 codes x spc positives and as
    many negatives). Each call's synchronised stages come from wrapping
    the module functions it calls: read (load_reference_stats), simulate
    (_simulate_codes), augment (from the draws to train_classifier: the
    device augmentation, the copy to the host, code strings and check
    bits; the FRET builder simulates and augments code by code, one stage
    there), heads (train_classifier up to the kNN matrix: padding, the
    copies, the draws and the Adam loop, of which "heads loop" is
    train_check_heads alone), prototypes (knn_reference) and save."""
    from hiprfish_tpu_torch.cli import train as cli_train
    from hiprfish_tpu_torch.config import TEN_BIT
    from hiprfish_tpu_torch.models import classifier as mclf
    from hiprfish_tpu_torch.models import train as mtrain
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.utils import synthetic

    dev = torch.device(dev)

    def clocked(name, fn, marks):
        def run(*a, **kw):
            _sync(torch, dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(torch, dev)
            marks[name] = (t0, time.perf_counter())
            return out
        return run

    targets = ((mtrain, "load_reference_stats", "read"),
               (mtrain, "_simulate_codes", "simulate"),
               (mtrain, "train_classifier", "classifier"),
               (mclf, "train_check_heads", "heads loop"),
               (mclf, "knn_reference", "prototypes"),
               (mtrain, "save_classifier", "save"))
    out = {}
    with tempfile.TemporaryDirectory(prefix="hf_train_") as tmp:
        folder = os.path.join(tmp, "hiprfish_1023_reference")
        t0 = time.perf_counter()
        synthetic.write_reference_folder(TEN_BIT, folder, range(1, 1024),
                                         cells_per_code=60, seed=0)
        print(f"phase 17c reference folder: 1023 codes x 60 cells written "
              f"in {time.perf_counter() - t0:.1f} s")
        for variant, n_codes, bar in (("violet_derivative", 1023, 0.99),
                                      ("fret_biofilm_7b", 127, None)):
            marks = {}
            saved = [(m, a, getattr(m, a)) for m, a, _ in targets]
            before = set(os.listdir(folder))
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            try:
                for m, a, name in targets:
                    setattr(m, a, clocked(name, getattr(m, a), marks))
                t0 = time.perf_counter()
                cli_train.main([folder, "-v", variant, "-s", str(spc),
                                "--device", device_flag])
                _sync(torch, dev)
                wall = time.perf_counter() - t0
            finally:
                for m, a, fn in saved:
                    setattr(m, a, fn)
            peak = (torch.cuda.max_memory_allocated() / 2**30
                    if dev.type == "cuda" else None)
            dur = {k: e - s for k, (s, e) in marks.items()}
            stages = {"read": dur["read"]}
            if "simulate" in marks:
                stages["simulate"] = dur["simulate"]
                stages["augment"] = marks["classifier"][0] \
                    - marks["simulate"][1]
            else:
                stages["simulate+augment"] = marks["classifier"][0] \
                    - marks["read"][1]
            stages["heads"] = marks["prototypes"][0] - marks["classifier"][0]
            stages["heads loop"] = dur["heads loop"]
            stages["prototypes"] = dur["prototypes"]
            stages["save"] = dur["save"]
            new = sorted(set(os.listdir(folder)) - before)
            clf = load_classifier(os.path.join(folder, new[0]))
            acc, n_means = _self_accuracy(torch, clf, folder, dev)
            rows = n_codes * spc
            width = clf.check_slice[0]
            print(f"phase 17c cli.train -v {variant} -s {spc}: {rows} "
                  f"simulated rows x {width} features"
                  f"{' + as many negatives' if n_codes == 127 else ''}, "
                  f"{len(clf.check_params)} heads, "
                  f"{len(clf.codebook)} codes, kNN matrix "
                  f"{clf.train_features.shape}; {wall:.2f} s; stages (s): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
                  + f"; peak device memory "
                  f"{'n/a' if peak is None else f'{peak:.2f} GiB'}; "
                  f"self-accuracy {acc:.4f} over {n_means} measured means; "
                  f"artifact {new[0]}")
            if len(new) != 1 or len(clf.codebook) != n_codes \
                    or clf.train_features.shape[0] != 8 * n_codes:
                raise AssertionError(f"17c {variant}: unexpected artifact")
            if bar is not None and acc < bar:
                raise AssertionError(f"17c {variant}: self-accuracy {acc} "
                                     f"below {bar}")
            out[variant] = {"rows": rows, "features": width,
                            "seconds": wall, "stages": stages,
                            "peak_gib": peak, "self_accuracy": acc,
                            "measured_means": n_means, "artifact": new[0],
                            "knn_rows": int(clf.train_features.shape[0])}
    return out


def _write_experiment(root: str, rows, mode: str, clf: str,
                      clf_name: str) -> tuple:
    """A workflow experiment under ``root``: data/fovs (the planes, linked
    or written by the caller), data/ref/<clf_name> linked to ``clf``, the
    experiment table with ``rows`` (IMAGES, SPC) and the config. Returns
    (config path, table path, fovs folder)."""
    fovs = os.path.join(root, "data", "fovs")
    os.makedirs(fovs)
    os.makedirs(os.path.join(root, "data", "ref"))
    os.symlink(clf, os.path.join(root, "data", "ref", clf_name))
    table = os.path.join(root, "images_table.csv" if mode == "R"
                         else "images_table_mix_0.csv")
    with open(table, "w") as f:
        f.write("SAMPLE,IMAGES,CALIBRATION,CALIBRATION_FILENAME,"
                "REFERENCE_FOLDER,SPC\n")
        f.writelines(f"fovs,{image},F,none,ref,{spc}\n"
                     for image, spc in rows)
    config = os.path.join(root, "hiprfish_config_imaging.json")
    with open(config, "w") as f:
        json.dump({"__default__": {"SCRIPTS_PATH": "",
                                   "DATA_DIR": os.path.join(root, "data")},
                   "images": {"image_list_table": table,
                              "image_type": mode}}, f)
    return config, table, fovs


def _link_planes(src: str, sample: str, dst: str, image: str, lasers):
    for laser in lasers:
        os.symlink(os.path.join(src, f"{sample}_{laser}.npy"),
                   os.path.join(dst, f"{image}_{laser}.npy"))


def _workflow_run(torch, kernels, config: str, family: str, name: str):
    """cli.workflow at its defaults (device cuda, max_cells 4096), its
    launches counted from zero. Returns (RunLog, seconds, launches)."""
    from hiprfish_tpu_torch.cli import workflow as cli_workflow

    kernels.reset_launches()
    t0 = time.time()
    log = cli_workflow.main([config, "--family", family])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = kernels.launch_counts()
    summary = log.summary()
    print(f"phase 18 {name}: {seconds:.2f} s; " + ", ".join(
        f"{k} {v['total_s']:.3f} s / {v['count']} = "
        f"{v['total_s'] / v['count']:.3f} s per call"
        for k, v in summary.items()) + f"; launches {launches}")
    return log, seconds, launches


def _workflow_phase(torch, kernels, fixture_10b: str, fixture_7b: str,
                    planes: str) -> dict:
    """Phase 18: cli.workflow on the 2000^2 FOVs, the measure -> classify
    -> collect loop in one process; ``planes`` holds phase 14's planes and
    truth labels."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
    from hiprfish_tpu_torch.io import tables
    from hiprfish_tpu_torch.utils import synthetic

    t_phase = time.time()
    # the bar of phases 5, 11 and 14: >= 0.95 of the planted cells
    min_cells = int(0.95 * len(synthetic.ECOLI_CODES))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) ecoli, mode R: two single-code reference FOVs
        config_r, table_r, fovs_r = _write_experiment(
            os.path.join(tmp, "ecoli_R"),
            [(f"run_enc_{enc}", WORKFLOW_SPC_10B) for enc in WORKFLOW_ENCS],
            "R", fixture_10b, WORKFLOW_CLF_10B)
        t0 = time.time()
        for enc in WORKFLOW_ENCS:
            fov = synthetic.make_fov(
                TEN_BIT, [enc] * len(synthetic.ECOLI_CODES),
                synthetic.ECOLI_SHAPE, seed=enc,
                laser_shifts=synthetic.ECOLI_SHIFTS,
                cell_axes=synthetic.ECOLI_CELL_AXES)
            for laser, plane in zip(LASERS_10B, fov["stack"]):
                np.save(os.path.join(fovs_r, f"run_enc_{enc}_{laser}.npy"),
                        plane)
            del fov
        print(f"phase 18 (a) two single-code 10-bit FOVs written in "
              f"{time.time() - t0:.1f} s")
        log, sec, launches = _workflow_run(
            torch, kernels, config_r, "ecoli", "(a) ecoli R")
        res = tables.read_columns(table_r[:-len(".csv")] + "_results.csv")
        if (len(res["NCells"]) != 2 or (res["NCells"] < min_cells).any()
                or not (res["ErrorRate"] <= WORKFLOW_MAX_ERROR).all()
                or not set(res["ErrorRateUpperLimit"]) <= {"T", "F"}):
            raise AssertionError(f"cli.workflow ecoli R: results {res}")
        missing = [k for k in PATH_CLI_MEASURE if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by cli.workflow "
                                 f"ecoli R: {missing}")
        out["ecoli R"] = {
            "seconds": sec, "summary": log.summary(), "launches": launches,
            "n_cells": res["NCells"].tolist(),
            "error_rate": res["ErrorRate"].tolist(),
            "upper_limit": list(res["ErrorRateUpperLimit"])}
        print(f"phase 18 (a) NCells {out['ecoli R']['n_cells']}, ErrorRate "
              f"{out['ecoli R']['error_rate']}, upper limit "
              f"{out['ecoli R']['upper_limit']}")

        # (b) ecoli, mode M: phase 14's 400-code FOV
        config_m, table_m, fovs_m = _write_experiment(
            os.path.join(tmp, "ecoli_M"), [("run_mix_0_fov_1",
                                            WORKFLOW_SPC_10B)],
            "M", fixture_10b, WORKFLOW_CLF_10B)
        _link_planes(planes, "ecoli_enc_5", fovs_m, "run_mix_0_fov_1",
                     LASERS_10B)
        log, sec, launches_m = _workflow_run(
            torch, kernels, config_m, "ecoli", "(b) ecoli M")
        res = tables.read_columns(table_m[:-len(".csv")] + "_results.csv")
        ab = tables.read_columns(table_m[:-len(".csv")]
                                 + "_results_abundance.csv")
        with open(os.path.join(fovs_m, "run_mix_0_fov_1_cell_ids.txt")) as f:
            n_ids = len(f.read().split())
        counts = ab["FOV1"]
        planted = np.isin(ab["Barcodes"], synthetic.ECOLI_CODES)
        on_planted = float(counts[planted].sum() / max(counts.sum(), 1))
        n_planted = int((counts[planted] >= 1).sum())
        print(f"phase 18 (b) abundance rows {len(counts)}, FOV1 sum "
              f"{counts.sum():.0f}, cell ids {n_ids}, NCells "
              f"{int(res['NCells'][0])}, planted codes counted {n_planted} "
              f"of {len(synthetic.ECOLI_CODES)}, on planted codes "
              f"{on_planted:.4f}")
        if (len(counts) != 2 ** TEN_BIT.n_bits - 1 or counts.sum() != n_ids
                or n_ids != res["NCells"][0] or n_planted < min_cells
                or on_planted < 0.99):
            raise AssertionError("cli.workflow ecoli M: abundance table "
                                 "off")
        missing = [k for k in PATH_CLI_MEASURE if launches_m[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by cli.workflow "
                                 f"ecoli M: {missing}")
        out["ecoli M"] = {"seconds": sec, "summary": log.summary(),
                          "launches": launches_m, "n_cells": n_ids,
                          "planted_counted": n_planted,
                          "on_planted": on_planted}

        # (c) multispecies: phase 14's 7-bit flagship FOV
        sample = "community_A_564_fov_1"
        config_s, _, fovs_s = _write_experiment(
            os.path.join(tmp, "multispecies"), [(sample, WORKFLOW_SPC_7B)],
            "R", fixture_7b, WORKFLOW_CLF_7B)
        _link_planes(planes, "flagship", fovs_s, sample, LASERS_7B)
        log, sec, launches_s = _workflow_run(
            torch, kernels, config_s, "multispecies", "(c) multispecies")
        seg, codebook, idx = _artifact_calls(os.path.join(fovs_s, sample),
                                             True)
        n_found = len(codebook) - 1
        correct, matched = _barcode_accuracy(
            seg, np.load(os.path.join(planes, "flagship_truth.npy")), idx,
            synthetic.FLAGSHIP_CODES, codebook, SEVEN_BIT, n_found,
            n_found + 1)
        print(f"phase 18 (c) n_cells {n_found}, matched {matched}, "
              f"accuracy {correct / max(matched, 1):.4f} from the artifacts")
        if matched != CLI_MATCHED_7B or correct != matched:
            raise AssertionError(f"cli.workflow multispecies: {correct}/"
                                 f"{matched} matched cells correct, "
                                 f"expected {CLI_MATCHED_7B}/"
                                 f"{CLI_MATCHED_7B}")
        missing = [k for k in PATH_CLI_MULTISPECIES if launches_s[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by cli.workflow "
                                 f"multispecies: {missing}")
        out["multispecies"] = {"seconds": sec, "summary": log.summary(),
                               "launches": launches_s, "n_cells": n_found,
                               "matched": matched,
                               "accuracy": correct / max(matched, 1)}

        # (d) (a) again: every stage's outputs are fresh
        plane_names = {f"run_enc_{enc}_{laser}.npy"
                       for enc in WORKFLOW_ENCS for laser in LASERS_10B}
        artifacts = sorted(os.path.join(fovs_r, f)
                           for f in os.listdir(fovs_r)
                           if f not in plane_names)
        mtimes = [os.path.getmtime(a) for a in artifacts]
        log, sec, launches_d = _workflow_run(
            torch, kernels, config_r, "ecoli", "(d) ecoli R again")
        reran = {e["stage"] for e in log.events} & {"measure", "classify"}
        if (reran or any(launches_d.values())
                or [os.path.getmtime(a) for a in artifacts] != mtimes):
            raise AssertionError(f"cli.workflow re-ran fresh stages: "
                                 f"{reran}, launches {launches_d}")
        out["ecoli R again"] = {"seconds": sec, "summary": log.summary(),
                                "artifacts_unchanged": len(artifacts)}
        written = sum(os.lstat(os.path.join(d, f)).st_size
                      for d, _, files in os.walk(tmp) for f in files
                      if not os.path.islink(os.path.join(d, f)))
        out["bytes_written"] = written
        print(f"phase 18 (d) second run {sec:.2f} s: no stage re-ran, no "
              f"kernel launched, {len(artifacts)} artifacts unchanged")
    out["seconds"] = time.time() - t_phase
    print(f"phase 18: {out['seconds']:.1f} s, {written} bytes written")
    return out


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _smooth_image(shape, seed: int):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(yy / 17.0) * np.cos(xx / 23.0) \
        + 0.005 * rng.randn(*shape)
    return img.astype(np.float32)


def main() -> int:
    t_start = time.time()
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
    print(_card_line())
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")

    # 2. build: the library and, beside it, phase 13's B6 instances
    t0 = time.time()
    cfgs3 = sorted({c[:3] for c in DOMAIN_LPCV3D})
    with ThreadPoolExecutor(1 + len(cfgs3)) as pool:
        jobs = [pool.submit(_build.build)] + [
            pool.submit(_build.build_lpcv3d, *c) for c in cfgs3]
        lib, *libs3 = (j.result() for j in jobs)
    _build.load()
    print(f"phase 2 build: {time.time() - t0:.1f} s -> {lib}, "
          f"{[str(p) for p in libs3]}")
    for stem in ("nlm", "lpcv2d", "segstats", "lpcv3d"):
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
        text = (f"bound {bound_ms:.4g} ms ({bound_by}) share "
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
    check("lpcv2d", lambda: kernels.lpcv2d(den, 11, 9),
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

    def domain(name, base, kernel, plain, reps, work, tol):
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        ok = err <= tol
        ms = _time_ms(torch, kernel, reps)
        plain_ms = _time_ms(torch, plain, 1)
        yard, text = yardsticks(ms, work, None, 0)
        print(f"phase 13 {name}: max_abs_err {err:.3e} (tol {tol:.1e} abs) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms {text} "
              f"{'ok' if ok else 'FAIL'}")
        domains[name] = {"max_abs_err": err, "tol": tol, "ok": ok, "ms": ms,
                         "plain_ms": plain_ms, **yard}

    hh, ww, patch, pd = DOMAIN_NLM
    img13 = torch.from_numpy(_smooth_image((hh, ww), 13)).to(dev)
    domain(f"nlm patch {patch} pd {pd} {hh}x{ww}", "nlm",
           lambda: kernels.nlm(img13, 0.02, patch, pd),
           lambda: denoise.denoise_nl_means_plain(img13, 0.02, patch, pd), 3,
           kernel_work("nlm", h=hh, w=ww, pd=pd), TOL["nlm"])
    for p2, phi in DOMAIN_LPCV2D:
        domain(f"lpcv2d ({p2}, {phi}) {hh}x{ww}", "lpcv2d",
               lambda: kernels.lpcv2d(img13, p2, phi),
               lambda: line_profile.lp_cv_enhance_2d_plain(img13, p2, phi),
               10, kernel_work("lpcv2d", h=hh, w=ww, patch=p2, phi=phi),
               lpcv2d_tol(phi))
    vol13 = torch.from_numpy(_volume_stack([1, 9, 65, 127], (40, 36, 24))
                             .sum(axis=3)).to(dev)
    vol13 = (vol13 / vol13.max()).permute(0, 2, 1).contiguous()
    for *cfg3, bf16 in DOMAIN_LPCV3D:
        domain(f"lpcv3d {tuple(cfg3)} {'bf16' if bf16 else 'f32'} "
               f"{'x'.join(map(str, vol13.shape))}", "lpcv3d",
               lambda: kernels.lpcv3d(vol13, bf16, *cfg3),
               lambda: line_profile.lp_cv_enhance_3d_plain(
                   vol13, *cfg3, bf16=bf16, layout="xzy"), 10,
               kernel_work("lpcv3d", voxels=vol13.numel(), patch=cfg3[0],
                           theta=cfg3[1], phi=cfg3[2]), TOL["lpcv3d"])
    if not all(d["ok"] for d in domains.values()):
        raise AssertionError("a kernel disagrees with its plain twin beyond "
                             "the main paths' configurations")

    # 14. the four command lines at full size
    del estack, hres
    torch.cuda.empty_cache()
    planes = tempfile.TemporaryDirectory()
    clis = _cli_phase(torch, kernels, FIXTURE_10B, FIXTURE, planes.name)

    # 15. the biofilm engine, cli.biofilm -d 2 and -z
    torch.cuda.empty_cache()
    bio = _biofilm_phase(torch, kernels, FIXTURE, dev)

    # 16. the volumetric analysis (the untiled 3D engine): (a) CPU vs card
    torch.cuda.empty_cache()
    vol_a = _volume_cpu_vs_card(torch, kernels, dev)
    # (b) B6, B3 and B4 at the shapes one microscope tile gives them
    tspec = s3.VolumeSpec(shape=TILE_SHAPE, spacing=(36, 36, 52), seed=5)
    tx3, ty3, tz3 = TILE_SHAPE
    lut_dev = torch.from_numpy(lut.astype(np.float32)).to(dev)
    tsum = s3.build_sum_volume(tspec, len(codes3), lut_dev.sum(dim=1).cpu(),
                               seed=1, z_chunk=16, device=dev)
    tile_xzy = (tsum / tsum.max()).permute(0, 2, 1).contiguous()
    del tsum
    out_k = kernels.lpcv3d(tile_xzy, True)
    out_p, plain_tile_ms = _time_once(
        torch, lambda: line_profile.lp_cv_enhance_3d_plain(
            tile_xzy, bf16=True, layout="xzy"))
    err_tile, ok_tile = _agree(torch, "lpcv3d", out_k, out_p)
    del out_k, out_p
    torch.cuda.empty_cache()
    ms_tile = _time_ms(torch, lambda: kernels.lpcv3d(tile_xzy, True), 5)
    yard, text = yardsticks(ms_tile, kernel_work(
        "lpcv3d", voxels=tile_xzy.numel()), None, 0)
    print(f"phase 16b lpcv3d on the tile's {tuple(tile_xzy.shape)} (X, Z, Y) "
          f"sum: max_abs_err {err_tile:.3e} ({TOL_TEXT['lpcv3d']}) kernel "
          f"{ms_tile:.3f} ms plain {plain_tile_ms:.3f} ms (one call) {text} "
          f"{'ok' if ok_tile else 'FAIL'}")
    if not ok_tile:
        raise AssertionError("lpcv3d: kernel disagrees with plain on the "
                             "tile")
    report["lpcv3d[tile]"] = {"max_abs_err": err_tile, "ms": ms_tile,
                              "plain_ms": plain_tile_ms, **yard,
                              "shape": list(tile_xzy.shape)}
    del tile_xzy
    # the seed filter's counts (32768 segments) and keep-table lookup over
    # the tile's (X, Y, Z) labels, here its planted cells ranked 1..
    vlab = torch.cat([s3.truth_chunk(tspec, len(codes3), z0,
                                     min(10, tz3 - z0), dev)[0]
                      for z0 in range(0, tz3, 10)], dim=2)
    vlab = torch.unique(vlab, return_inverse=True)[1].to(torch.int32)
    vflat = vlab.reshape(-1)
    n_vox = int((vflat > 0).sum())
    print(f"phase 16b tile labels {tuple(vlab.shape)}: {int(vflat.max())} "
          f"cells, {n_vox} labelled voxels")
    check_b3("volume3d", (vflat, None, None, None, SEED_SEGMENTS, 0, False,
                          tx3, vflat.numel() // tx3), 10, 3,
             kernel_work("label_stats", pixels=vflat.numel(),
                         labelled=n_vox, ncols=2, row_bytes=0,
                         segments=SEED_SEGMENTS),
             lambda: torch.bincount(vflat, minlength=SEED_SEGMENTS),
             phase="16b")
    vtbl = torch.rand(SEED_SEGMENTS, generator=gen).to(dev)
    vtbl0 = vtbl.clone()
    vtbl0[0] = 0.0
    check("label_lookup[volume3d]", lambda: kernels.label_lookup(vlab, vtbl),
          lambda: segstats.label_lookup_plain(vlab, vtbl), 10, 3,
          kernel_work("label_lookup", pixels=vflat.numel(),
                      segments=SEED_SEGMENTS),
          lambda: torch.index_select(vtbl0, 0, vflat), phase="16b")
    del vlab, vflat, vtbl, vtbl0
    torch.cuda.empty_cache()
    # (c) cli.biofilm -d 3 on the tile
    vol_c = _volume_cli_phase(torch, kernels, FIXTURE, dev, lut_dev)

    # 17. classifier training: (a) CPU vs card at a small size
    del lut_dev
    torch.cuda.empty_cache()
    train_a = _train_cpu_vs_card(torch, dev)
    # (b) the fixtures' recipes retrained on the card, then both 2000^2
    # steps with the port-trained classifiers
    trained, train_b = _train_recipes(torch, dev)
    train_b.update(_trained_steps(torch, kernels, dev, trained, n_found,
                                  en_found))
    launches17 = train_b["fov_step"]["launches"]
    launches17e = train_b["fov_step_ecoli"]["launches"]
    del trained
    torch.cuda.empty_cache()
    # (c) cli.train at the reference's defaults
    train_c = _train_cli_phase(torch, dev)

    # 18. cli.workflow: measure -> classify -> collect in one process
    torch.cuda.empty_cache()
    wf = _workflow_phase(torch, kernels, FIXTURE_10B, FIXTURE, planes.name)
    planes.cleanup()

    by_path = {"fov_step": (launches, PATH_2D),
               "volume_3d": (launches3, PATH_3D),
               "fov_step_ecoli": (launches10, PATH_ECOLI),
               "cli.measure": (clis["measure"]["launches"],
                               PATH_CLI_MEASURE),
               "cli.measure_multispecies": (
                   clis["measure_multispecies"]["launches"],
                   PATH_CLI_MULTISPECIES),
               "cli.biofilm -d 2": (
                   bio["cli.biofilm -d 2"]["cold"]["launches"], PATH_BIOFILM),
               "cli.biofilm -z": (bio["cli.biofilm -z"]["launches"],
                                  PATH_BIOFILM),
               "cli.biofilm -d 3": (vol_c["launches"], PATH_BIOFILM_3D),
               "fov_step, port-trained": (launches17, PATH_2D),
               "fov_step_ecoli, port-trained": (launches17e, PATH_ECOLI),
               "cli.workflow ecoli": (
                   {k: wf["ecoli R"]["launches"][k]
                    + wf["ecoli M"]["launches"][k]
                    for k in wf["ecoli R"]["launches"]}, PATH_CLI_MEASURE),
               "cli.workflow multispecies": (
                   wf["multispecies"]["launches"], PATH_CLI_MULTISPECIES)}
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
    print(f"chip_smoke total {time.time() - t_start:.1f} s")
    # the card's line again beside the results (the first one may be far
    # above them in a long output)
    print(_card_line())
    print(json.dumps({"kernels": entries, "domains": domains,
                      "clis": clis, "biofilm": bio,
                      "volume": {"cpu vs card": vol_a,
                                 "cli.biofilm -d 3": vol_c},
                      "training": {"cpu vs card": train_a,
                                   "recipes": train_b,
                                   "cli.train": train_c},
                      "workflow": wf}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
