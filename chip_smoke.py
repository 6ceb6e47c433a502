#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (hiprfish_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the script exits
non-zero and prints no result:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source) and, in
     parallel with them, B6's instances for the configurations (7, 5, 6),
     (21, 5, 4) and (29, 3, 4) of phase 13; print the build time and
     ptxas's registers and spills of B1, B2, B3/B4/B5, B6 and the flood
     rounds;
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
     and the peak device memory, and each stage's peak;
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
     The planes, truth labels and measured spectra are kept (moved, not
     copied) for 18-20;
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
 19. the Zeiss readers (io/czi.py, io/jxr.py, io/czi_native.py; their host
     libraries built by g++ from native/*.cc) and the batch runner:
     libjxr.so must build; the native assembler's path is expected where
     /usr/include holds zstd.h and jpeglib.h, the Python parser's
     elsewhere, and every read must take the expected path (printed with
     its reason). (a) phase 14's 7-bit planes as four Gray32Float .czi
     through cli.measure_multispecies -> cli.classify_spectra: 389 of 389
     at 1.0 and phase 14's labels and calls; (b) its 10-bit planes as
     five Gray16 JPEG-XR .czi (round(plane / 1.25 * 65535)) read back
     bitwise as counts / 65535, then cli.measure -c F -> cli.classify: >=
     0.99 over >= 380 matched; (c) run_batch_pipeline on the card over
     (a)'s files and two more flagship-recipe FOVs (seeds 2, 3) as Gray16
     JPEG-XR: >= 0.99 over >= 380 matched per FOV, B1-B4 launched three
     fov_step calls' worth, each FOV's worker decode seconds and step
     seconds and the sweep's wall seconds printed, and the loader's staged
     planes (pinned, side stream) bitwise equal to plain copies; (d) cli.biofilm -d 3 on
     16a's 96 x 64 x 32 volume as .npy and as Gray32Float .czi z-stacks:
     byte-identical artifacts, B6, B3 and B4 launched. The phase prints
     its seconds and bytes (at most 6 GB).
 20. the reference's legacy UMAP classifier stacks (models/umap_infer.py;
     no kernel of their own: every count must stay 0): (a) a 10-bit stack
     at the reference's training width (utils/legacy_stacks.reference_stack:
     1023 codes x 2000 = 2,046,000 rows x 132, the check SVCs scored on
     those rows first, >= 0.99 each) written in joblib's format, then
     cli.classify -rf <name>_umap_transform.pkl on phase 14's 10-bit
     _avgint.csv twice (cold, warm): >= 380 matched cells at accuracy >=
     0.99 read back from _cell_ids.txt with _seg.npy, the same artifacts
     in both calls, each call's stage seconds (load, check SVCs, distance
     and top-k, weights, epochs, SVC, write) and peak device memory; (b)
     the same for a 7-bit stack (127 x 2000 = 254,000 rows x 67, with its
     StandardScaler) through cli.classify_spectra -r
     <name>_umap_transform_biofilm_7b.pkl on phase 14's _avgint_norm.csv,
     read back from _cell_information.csv; (c) a 20,460-row 10-bit stack
     of the same recipe on the CPU and on the card over phase 14's
     measured cells with the same negative draws: equal check bits,
     neighbours and calls, distances within 2e-6, embeddings within 1e-4,
     the embedded SVC's decisions on one embedding within 1e-5; (d) the
     committed real-sklearn stacks
     (tests/fixtures/legacy_stacks/, tools/make_torch_legacy_fixture.py):
     sklearn's stored predictions exactly, predict_proba within 5e-3, the
     held-out codes at >= 0.99. The phase prints its seconds and bytes (at
     most 60 s and 2 GB).
 21. the scale-out over torch.distributed (hiprfish_tpu_torch/parallel/,
     utils/oom.py and the mesh paths of pipeline/segment3d.py): (a) world
     1 over NCCL in this process, joined through the HIPRFISH_* contract:
     batched_fov_step over two copies of the 2000^2 7-bit FOV and
     batched_fov_step_ecoli over two of the 10-bit FOV, each FOV's labels
     and calls equal to phases 5 and 11's single-FOV steps;
     lp_cv_enhance_2d_sharded of a 2000^2 image bitwise B2 on the whole
     image; segment_3d_tiled(mesh=) on 16a's 96 x 64 x 32 volume (four
     tiles) with the host sweep's labels; measure_volume_zsharded on it
     against measure_volume_streamed within B5's contract twice over
     (2^-15 relative); train_check_heads_dp against train_check_heads on
     4,096 rows (one full batch of the latter, so both take the same step)
     within 1e-5 after 20 steps; (b) the same checks in a world of two
     spawned ranks sharing the card over gloo (the halo, the tiles and the
     z-slabs crossing ranks), then run_distributed_pipeline over phase
     14's 7-bit planes as four samples: labels and calls byte for byte,
     the spectra CSVs within 2^-14 relative (B3's float sums in two runs),
     of run_batch_pipeline's in this process; (c) in a spawned process of
     its own (NCCL, world 1), run_batch_pipeline over the four samples at
     batch 2, its peak reserved memory measured, then at batch 4 under
     torch.cuda.set_per_process_memory_fraction of that peak + 512 MiB: an
     allocator OOM must be taken by the halving (2 x 2) and the artifacts
     must equal the uncapped run's as in (b). Every path prints its
     seconds (cold, warm), ms per FOV and launches, and must launch its
     kernels (B1-B4, B2, B3/B4/B6, B5). Each spawned world is bounded by
     300 s and its process-group timeout.
 22. in-tile seeds, their out-of-memory fallback, the warm-up command and
     the stencil forms: (a) phase 8's pass again with
     segment_3d_tiled(global_seeds=False), each tile seeding its own
     slab: labels byte-identical to phase 8's, the same n_cells, phase
     8's bars, B3-B6 launched; seconds and each stage's peak beside phase
     8's; (b) in a spawned process, segment_3d_tiled on 16a's 96 x 64 x 32
     volume with in-tile and with global seeds, then with global seeds
     under a real allocator OOM in _global_seeds (a memory cap between
     the stages' peaks where they stand INTILE_CAP_GAP apart, else a
     ballast filling the card as _global_seeds starts): the OOM taken by
     the fallback, its one warning, the in-tile labels; (c) python -m
     hiprfish_tpu_torch.cli.warmup --family ecoli multispecies 3d --size
     2000 in a process of its own: rc 0 and its steps' seconds, beside
     phase 2's build seconds; (d) B6 (bf16, f32) on a 64 x 170 x 64
     (X, Z, Y) sub-volume of the fixture and B2 on a 512^2 image against
     the stencil forms on the card (the combine of line_profile_3d, and
     of line_profile_2d's normalised centres), within 1e-6;
 23. touching cells at production density (make_fov's dense mode, the
     scenes of tools/make_parity.py::fov_scene: 441 cells on a 2000^2
     FOV, 7-bit at a 27 px pitch, 10-bit at 31 px; per family a nominal
     scene, a high-noise one (noise 0.05) and a misregistered one, the
     10-bit family near the +-15 px registration clamp, the 7-bit one at
     moderate drift on a smooth illumination mottle): (a) a 256^2
     touching-cell FOV of each family through its step on the CPU (plain
     versions) and on the card, held as in phases 4 and 10; (b) the
     7-bit scenes through fov_step with the 127-code classifier and (c)
     the 10-bit scenes through fov_step_ecoli with the 1023-class one, at
     max_cells 8192: accuracy >= 0.99 over the matched cells, matched >=
     0.95 x 441 (nominal) or 0.90 x 441, n_cells and labels equal in
     every call, B1-B4 (7-bit) or B3 and B4 (10-bit) launched; ms/FOV
     (median of 3 after the first call) and peak device memory per
     scene. It writes nothing to disk.
 24. the fixpoint floods from CUDA graphs (ops/labeling._fixpoint, which
     replays graphs of k rounds for 2D CUDA tensors): (a) every flood of
     fov_step and of fov_step_ecoli on phase 23's nominal scenes, its
     inputs recorded in one step and run again from the graphs and one
     round at a time (the graphs turned off): bitwise outputs, equal
     rounds, >= 1 replay, and both times (median of 5 synchronised
     calls); (b) both steps with and without the graphs on two FOVs each
     of 7-bit touching cells and 10-bit touching cells (phase 23's
     nominal and high_noise scenes) and 7-bit sparse cells (the flagship
     FOV, and its layout at seed 2): labels, n_cells, calls and valid
     bitwise; (c) the driver's graph captures in the process and replays
     in the phase, both > 0;
 25. the flood rounds on csrc/flood.cu (kernels.flood_min, flood_reach)
     against their plain twins from the same random masks and states: a
     3D tile's CCL and rank (488 x 170 x 2020, connectivity 3, cap 32),
     the 3D seeds' fill-holes (2020 x 170 x 2020, connectivity 1,
     max_run 128) and the 2D floods at 2000^2 (caps 16 and 64): bitwise
     outputs, ms a round alone and with the change test beside the bound
     of its passes' bytes, and the plain round's ms.

B4 stores float32 or, for the label remaps of the steps and the 3D path,
int32 (label_lookup(out_dtype=torch.int32)); phases 3 and 6 hold its
int32 store bitwise to the twin at 2000^2 and at the 3D tile's shape,
and the kernels line has one entry per store and shape (an int32 entry's
launches count the int32 stores, label_lookup_i32). Phase 8 prints
its remap stage's peak beside the f32 store's and a digest of its labels.

At the end the script's total seconds and the card's line are printed,
then a JSON object with one entry per kernel (its launches on each path,
errors, times, bound and library call) and the other phases' results
(training and the workflow among them); the last line is {"ok": true,
"device": {...}}. The script imports neither jax
nor the JAX package hiprfish_tpu.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

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
# phase 19: the readers. Gray16 planes are round(plane / READER_SCALE *
# 65535): the 2000^2 7-bit and 10-bit FOVs reach 1.2008 and 1.1978, so
# every value keeps its place in [0, 1]; (c)'s two more flagship-recipe
# FOVs; the phase's disk and time budgets (the machine takes 45 GiB of
# disk writes per call, and phases 1-18 use ~38 GB)
READER_SCALE = 1.25
READER_SEEDS = (2, 3)
READER_MAX_BYTES = 6e9
READER_MAX_SECONDS = 90.0
# phase 20: the legacy UMAP stacks at the reference's training width
# (simulations per code of its trainer's default), (c)'s small stack, the
# committed real-sklearn stacks, and the phase's disk and time budgets
# (phases 1-19 write ~41.8 GB of the machine's 45 GiB)
LEGACY_SPC = 2000
LEGACY_SMALL_SPC = 20
LEGACY_FIXTURES = os.path.join(os.path.dirname(FIXTURE), "legacy_stacks")
LEGACY_MAX_BYTES = 2e9
LEGACY_MAX_SECONDS = 60.0
# the order of the kernels line: B3 once per column set, B4 once per shape
REPORT_ORDER = ("nlm", "lpcv2d", "label_stats[counts]", "label_stats[aux41]",
                "label_stats[cube7b]", "label_stats[cols10b]",
                "label_stats[tile3d]", "label_stats[volume3d]",
                "label_lookup[2000^2]", "label_lookup[2000^2 int32]",
                "label_lookup[tile3d]", "label_lookup[tile3d int32]",
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


def _remap_tables(torch, gen, nseg: int, dev):
    """(table, int32 table with row 0 zeroed) of a label remap as the
    steps build it: a random half of the ids kept and renumbered 1.. in
    order, the rest 0, as float32 for B4 (exact below 2^24)."""
    keep = torch.rand(nseg, generator=gen) < 0.5
    keep[0] = False
    ids = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0,
                                         dtype=torch.int32),
                      torch.zeros(nseg, dtype=torch.int32))
    return ids.to(torch.float32).to(dev), ids.to(dev)


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
                 log=lambda m: None, mark=lambda stage: None) -> dict:
    """One 3D pass, segment3d.volume_step, from the tiles (popped from the
    one-element list ``tile_box``, so they free after the stitch) of
    tools/bench3d.py's 2 x 4 grid with its 60-px overlap, and bf16
    channels-major slabs of ``spec``. Returns the labels, n_cells, mean
    spectra, calls and each stage's seconds (stitch, segment, measure,
    classify; synchronised). ``mark(stage)`` is called at the end of the
    stitch, of segment_3d_tiled's remap, of the measure and of the
    classify; ``log`` gets segment_3d_tiled's messages."""
    from hiprfish_tpu_torch.pipeline import segment3d
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    dev = lut_dev.device
    stages = {}
    names = {"stitch": "stitch", "remap": "segment", "measure": "measure",
             "classify": "classify"}
    t0 = [time.time()]

    def step_log(msg):
        if msg not in names:
            log(msg)
            return
        _sync(torch, dev)
        now = time.time()
        stages[names[msg]] = now - t0[0]
        t0[0] = now
        mark(msg)

    r = segment3d.volume_step(
        tile_box,
        lambda z0, zc: s3.channel_chunk_cm(spec, lut_dev.shape[0], z0, zc,
                                           lut_dev, 1, torch.bfloat16),
        arrays, static, cfg, max_cells, grid=(2, 4), overlap=60,
        z_chunk=z_chunk, log=step_log, **tiled)
    return {"seg_xzy": r.segmentation, "n_cells": r.n_cells,
            "avg": r.avgint, "pred": r.code_idx.cpu().numpy(),
            "stages": stages}


class _StagePeaks:
    """Each stage's peak allocated device memory in GiB, read and reset
    at the stage's end (``mark``): segment_3d_tiled's 'tile i/n' messages
    are one stage, 'tiles', and its 'merge: ...' message is 'merge'.
    ``base_gib`` is what was allocated when the pass began (tensors of
    earlier phases), which every peak includes."""

    def __init__(self, torch, dev):
        self.torch, self.dev, self.gib = torch, dev, {}
        self.base_gib = torch.cuda.memory_allocated(dev) / 2 ** 30 \
            if dev.type == "cuda" else 0.0

    def text(self) -> str:
        """The stages' peaks above base_gib."""
        return ", ".join(f"{k} {v - self.base_gib:.2f}"
                         for k, v in self.gib.items()) \
            + f" (above {self.base_gib:.2f} GiB live before the pass)"

    def mark(self, stage: str) -> None:
        if self.dev.type != "cuda":
            return
        key = "tiles" if stage.startswith("tile ") else stage.split(":")[0]
        peak = self.torch.cuda.max_memory_allocated(self.dev) / 2 ** 30
        self.torch.cuda.reset_peak_memory_stats(self.dev)
        self.gib[key] = max(self.gib.get(key, 0.0), peak)


def _volume_pass(torch, dev, spec, lut_dev, clf, cfg, tiled: dict,
                 max_cells: int, tag: str = "phase 8",
                 keep_labels: bool = False) -> dict:
    """The 3D pass on ``dev`` with launches counted from zero, then its
    accuracy against the planted truth. Returns stage seconds, total,
    n_cells, correct/matched, launch counts, peak device memory and each
    stage's peak, and with ``keep_labels`` the (X, Z, Y) labels on the
    host."""
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

    peaks = _StagePeaks(torch, dev)

    def log(msg):
        _sync(torch, dev)
        print(f"{tag}   +{time.time() - t_seg:.2f} s: {msg}")
        peaks.mark(msg)

    # hand the tiles over, so that they free after the stitch
    tile_box = [tiles]
    del tiles
    kernels.reset_launches()
    r = _volume_step(torch, tile_box, spec, lut_dev, arrays, static, cfg,
                     tiled, max_cells, log=log, mark=peaks.mark)
    total = time.time() - t_seg
    launches = kernels.launch_counts()
    peak = max(peaks.gib.values(), default=0.0)
    seg_xzy, avg = r["seg_xzy"], r["avg"]
    if seg_xzy.shape != (spec.shape[0], spec.shape[2], spec.shape[1]) \
            or not bool(torch.isfinite(avg).all()):
        raise AssertionError("3D path output malformed")
    correct, matched = _accuracy_3d(torch, s3, spec, n_codes, seg_xzy,
                                    r["pred"], lut_class, r["n_cells"],
                                    max_cells)
    out = {"stages": r["stages"], "total": total,
           "n_cells": r["n_cells"], "correct": correct, "matched": matched,
           "launches": launches, "peak_gib": peak,
           "stage_peaks_gib": peaks.gib, "base_gib": peaks.base_gib,
           "stage_peaks_text": peaks.text()}
    if keep_labels:
        out["seg_xzy"] = seg_xzy.cpu()
    return out


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
    labels are moved into ``keep`` for phases 18 to 20 (no second
    write), with each warm call's _seg.npy, calls and measured spectra."""
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
                # the planes for 18 and 19, the warm call's labels and
                # calls for 19 (a), the measured spectra for 20
                calls = (f"{sample}_cell_information.csv" if table
                         else f"{sample}_cell_ids.txt")
                spectra = (f"{sample}_avgint_norm.csv" if table
                           else f"{sample}_avgint.csv")
                for fname in [*names, f"{sample}_seg.npy", calls, spectra]:
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
        # host arrays: each goes to ``d``
        seg, n, _, _ = segment3d.segment_3d(
            list(blocks), SegmentationConfig(), 64, bf16=True, device=d,
            shifts=shifts)
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


def _native_headers() -> dict:
    """Which of the native assembler's headers /usr/include holds."""
    return {h: os.path.exists(os.path.join("/usr/include", h))
            for h in ("zstd.h", "jpeglib.h")}


def _reader_phase(torch, kernels, fixture_10b: str, fixture_7b: str,
                  planes: str, step_launches: dict, dev) -> dict:
    """Phase 19: the Zeiss readers and the batch runner on the card, in a
    temporary directory that is removed afterwards; ``planes`` holds phase
    14's planes, truth labels and warm-call artifacts, ``step_launches``
    one fov_step call's launches (phase 5)."""
    from hiprfish_tpu_torch.cli import biofilm as cli_biofilm
    from hiprfish_tpu_torch.cli import classify as cli_classify
    from hiprfish_tpu_torch.cli import classify_spectra as cli_spectra
    from hiprfish_tpu_torch.cli import measure as cli_measure
    from hiprfish_tpu_torch.cli import measure_multispecies as cli_ms
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
    from hiprfish_tpu_torch.io import _native_build, czi, czi_native, jxr
    from hiprfish_tpu_torch.io import images as iio
    from hiprfish_tpu_torch.io.loader import FovPrefetcher
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import fov_batch
    from hiprfish_tpu_torch.utils import synthetic

    t_phase = time.time()
    # the bar of phases 5, 11 and 14: >= 0.95 of the planted cells
    min_cells = int(0.95 * len(synthetic.FLAGSHIP_CODES))
    # both host libraries are built (or fail to) before any read is timed
    t0 = time.time()
    if not jxr.available():
        raise AssertionError(f"libjxr.so did not build: {jxr.build_error()}")
    try:
        czi_native.get_library()
        assembler = "built"
    except _native_build.NativeBuildError as e:
        assembler = f"not built ({czi._first_error(e)})"
    build_s = time.time() - t0
    headers = _native_headers()
    want_path = "native" if all(headers.values()) else "python"
    print(f"phase 19 host libraries ({build_s:.2f} s): libjxr.so built, "
          f"libczi_native.so {assembler}; headers {headers}: the "
          f"{want_path} CZI path is expected")
    codebook7 = list(load_classifier(fixture_7b).codebook)
    seen, out = set(), {"expected_path": want_path, "headers": headers,
                        "assembler": assembler, "build_s": build_s}
    cwd = os.getcwd()

    def written() -> int:
        """Bytes of the files written since the last call."""
        n = 0
        for d, _, files in os.walk("."):
            for f in files:
                path = os.path.join(d, f)
                if path not in seen:
                    seen.add(path)
                    n += os.path.getsize(path)
        return n

    def gray16(plane):
        return np.round(plane / np.float32(READER_SCALE)
                        * 65535).astype(np.uint16)

    def check_path(name):
        path, why = czi.last_decode()
        if path != want_path:
            raise AssertionError(f"phase 19 {name}: the {path} CZI path "
                                 f"decoded the planes ({why}), expected "
                                 f"the {want_path} one")
        return [path, why]

    def accuracy(seg, truth, idx, codes, codebook, layout):
        n = len(codebook) - 1
        correct, matched = _barcode_accuracy(seg, truth, idx, codes,
                                             codebook, layout, n, n + 1)
        return n, matched, correct / max(matched, 1)

    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # (a) Gray32Float CZIs through the 7-bit command lines
            names_a = [f"flagship_{laser}.czi" for laser in LASERS_7B]
            t0 = time.time()
            for name in names_a:
                czi.write_czi(name, np.load(os.path.join(
                    planes, name[:-4] + ".npy")))
            write_s = time.time() - t0
            t0 = time.time()
            iio.load_image_stack([os.path.join(planes, n[:-4] + ".npy")
                                  for n in names_a])
            npy_s = time.time() - t0
            t0 = time.time()
            iio.load_image_stack(names_a)
            read_s = time.time() - t0
            path_a = check_path("(a)")
            kernels.reset_launches()
            t0 = time.time()
            cli_ms.main(["-i", *names_a])
            cli_spectra.main(["-i", "flagship_avgint_norm.csv", "-r",
                              fixture_7b])
            torch.cuda.synchronize()
            cli_s = time.time() - t0
            launches_a = kernels.launch_counts()
            seg, codebook, idx = _artifact_calls("flagship", True)
            seg14, codebook14, _ = _artifact_calls(
                os.path.join(planes, "flagship"), True)
            n, matched, acc = accuracy(
                seg, np.load(os.path.join(planes, "flagship_truth.npy")),
                idx, synthetic.FLAGSHIP_CODES, codebook, SEVEN_BIT)
            same = bool(np.array_equal(seg, seg14) and codebook == codebook14)
            bytes_a = written()
            print(f"phase 19 (a) 4 Gray32Float CZIs ({bytes_a} bytes with "
                  f"the artifacts) written in {write_s:.2f} s, read in "
                  f"{read_s:.2f} s by the {path_a[0]} path ({path_a[1]}; "
                  f"the .npy planes: {npy_s:.2f} s); "
                  f"cli.measure_multispecies + cli.classify_spectra "
                  f"{cli_s:.2f} s: n_cells {n}, matched {matched}, accuracy "
                  f"{acc:.4f}, labels and calls as phase 14's .npy run: "
                  f"{same}; launches {launches_a}")
            if not same or matched != CLI_MATCHED_7B or acc != 1.0:
                raise AssertionError("phase 19 (a): the CZI run differs "
                                     "from phase 14's .npy run")
            missing = [k for k in PATH_CLI_MULTISPECIES if not launches_a[k]]
            if missing:
                raise AssertionError(f"kernels not launched by 19 (a): "
                                     f"{missing}")
            for f in os.listdir("."):
                if f not in names_a:
                    os.remove(f)
            out["a"] = {"write_s": write_s, "read_s": read_s,
                        "npy_read_s": npy_s,
                        "cli_s": cli_s, "path": path_a, "n_cells": n,
                        "matched": matched, "accuracy": acc,
                        "launches": launches_a}

            # (b) Gray16 JPEG-XR CZIs through the 10-bit command lines
            names_b = [f"ecoli_enc_5_{laser}.czi" for laser in LASERS_10B]
            counts, peak = [], 0.0
            t0 = time.time()
            for name in names_b:
                plane = np.load(os.path.join(planes, name[:-4] + ".npy"))
                peak = max(peak, float(plane.max()))
                counts.append(gray16(plane))
                czi.write_czi(name, counts[-1], pixel_type=1,
                              compression=czi.COMP_JPEGXR)
            write_s = time.time() - t0
            if peak > READER_SCALE:
                raise AssertionError(f"phase 19 (b): planes reach {peak}, "
                                     f"past the scale {READER_SCALE}")
            t0 = time.time()
            stack = iio.load_image_stack(names_b)
            read_s = time.time() - t0
            path_b = check_path("(b)")
            exact = all(np.array_equal(
                a.view(np.uint32),
                (c.astype(np.float32) / np.float32(65535)).view(np.uint32))
                for a, c in zip(stack, counts))
            del stack, counts
            kernels.reset_launches()
            t0 = time.time()
            cli_measure.main(["-i", *names_b, "-c", "F"])
            cli_classify.main(["ecoli_enc_5_avgint.csv", "-rf",
                               fixture_10b])
            torch.cuda.synchronize()
            cli_s = time.time() - t0
            launches_b = kernels.launch_counts()
            seg, codebook, idx = _artifact_calls("ecoli_enc_5", False)
            n, matched, acc = accuracy(
                seg, np.load(os.path.join(planes, "ecoli_enc_5_truth.npy")),
                idx, synthetic.ECOLI_CODES, codebook, TEN_BIT)
            bytes_b = written()
            print(f"phase 19 (b) 5 Gray16 JPEG-XR CZIs (planes up to "
                  f"{peak:.4f}, scaled by 1 / {READER_SCALE}; {bytes_b} "
                  f"bytes with the artifacts) written in {write_s:.2f} s, "
                  f"read in {read_s:.2f} s per FOV by the {path_b[0]} path, "
                  f"counts / 65535 bitwise: {exact}; cli.measure -c F + "
                  f"cli.classify {cli_s:.2f} s: n_cells {n}, matched "
                  f"{matched}, accuracy {acc:.4f}; launches {launches_b}")
            if not exact or matched < min_cells or acc < 0.99:
                raise AssertionError("phase 19 (b): JPEG-XR planes or calls "
                                     "off")
            missing = [k for k in PATH_CLI_MEASURE if not launches_b[k]]
            if missing:
                raise AssertionError(f"kernels not launched by 19 (b): "
                                     f"{missing}")
            for f in os.listdir("."):
                if f not in names_a:
                    os.remove(f)
            out["b"] = {"write_s": write_s, "read_s": read_s,
                        "cli_s": cli_s, "path": path_b, "exact": exact,
                        "peak": peak, "n_cells": n, "matched": matched,
                        "accuracy": acc, "launches": launches_b}

            # (c) run_batch_pipeline over three FOVs: (a)'s files and two
            # more flagship-recipe FOVs as Gray16 JPEG-XR
            samples = [("flagship", names_a)]
            truths = {"flagship": np.load(os.path.join(
                planes, "flagship_truth.npy"))}
            t0 = time.time()
            for seed in READER_SEEDS:
                fov = synthetic.make_fov(
                    SEVEN_BIT, list(synthetic.FLAGSHIP_CODES),
                    shape=synthetic.FLAGSHIP_SHAPE, seed=seed,
                    laser_shifts=synthetic.FLAGSHIP_SHIFTS,
                    cell_axes=synthetic.FLAGSHIP_CELL_AXES)
                files = [f"seed{seed}_{laser}.czi" for laser in LASERS_7B]
                for name, plane in zip(files, fov["stack"]):
                    if float(plane.max()) > READER_SCALE:
                        raise AssertionError(f"phase 19 (c): {name} past "
                                             f"the scale")
                    czi.write_czi(name, gray16(plane), pixel_type=1,
                                  compression=czi.COMP_JPEGXR)
                samples.append((f"seed{seed}", files))
                truths[f"seed{seed}"] = fov["truth_labels"]
                del fov
            write_s = time.time() - t0
            os.mkdir("batch")
            timings = {}
            kernels.reset_launches()
            t0 = time.time()
            res = fov_batch.run_batch_pipeline(
                samples, load_classifier(fixture_7b), device=dev,
                out_dir="batch", timings=timings)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches_c = kernels.launch_counts()
            per_fov = {}
            for name, _ in samples:
                seg, codebook, idx = _artifact_calls(
                    os.path.join("batch", name), False)
                n, matched, acc = accuracy(seg, truths[name], idx,
                                           synthetic.FLAGSHIP_CODES,
                                           codebook, SEVEN_BIT)
                per_fov[name] = {"n_cells": n, "matched": matched,
                                 "accuracy": acc, **timings[name]}
                print(f"phase 19 (c) {name}: n_cells {n} (returned "
                      f"{res[name][0]}), matched {matched}, accuracy "
                      f"{acc:.4f}; decode {timings[name]['decode']:.3f} s "
                      f"(worker), step {timings[name]['step']:.3f} s")
                if n != res[name][0] or matched < min_cells or acc < 0.99:
                    raise AssertionError(f"phase 19 (c) {name}: calls off")
            serial = sum(t["decode"] + t["step"] for t in timings.values())
            want_launches = {k: len(samples) * step_launches[k]
                             for k in PATH_2D}
            bytes_c = written()
            print(f"phase 19 (c) run_batch_pipeline, 3 FOVs ({write_s:.2f} "
                  f"s to synthesise and write two; {bytes_c} bytes): sweep "
                  f"{wall:.2f} s wall against {serial:.2f} s of decode + "
                  f"step; launches {launches_c} (3 x one fov_step: "
                  f"{want_launches})")
            if any(launches_c[k] != want_launches[k] for k in PATH_2D):
                raise AssertionError("phase 19 (c): launches are not three "
                                     "fov_step calls'")
            # the loader's staging (pinned buffers, a side stream): each
            # FOV's first plane, used at once on the consumer's stream,
            # against a plain copy of the plane read on the host
            staged = []
            with FovPrefetcher([(n, f[:1]) for n, f in samples],
                               device=dev) as loader:
                for (name, (plane,)), (_, files) in zip(loader, samples):
                    doubled = plane * 2.0
                    want = torch.from_numpy(iio.load_image(files[0])).to(dev)
                    staged.append(bool(torch.equal(plane, want)
                                       and torch.equal(doubled, want * 2.0)))
            print(f"phase 19 (c) FovPrefetcher on the card: each FOV's "
                  f"first plane equal to a plain copy bitwise: {staged}")
            if not all(staged):
                raise AssertionError("phase 19 (c): staged planes differ")
            out["c"] = {"write_s": write_s, "wall_s": wall,
                        "decode_plus_step_s": serial, "fovs": per_fov,
                        "launches": launches_c, "staged_equal": staged}
            for d, _, files in os.walk(".", topdown=False):
                for f in files:
                    os.remove(os.path.join(d, f))
            os.rmdir("batch")

            # (d) cli.biofilm -d 3 on 16a's volume as .npy and as CZI
            # z-stacks, each run from its own folder (the sample column
            # holds the folder as given)
            cube = _volume_stack([1, 9, 65, 127, 3, 5, 17, 33, 64],
                                 (96, 64, 32))
            runs = {}
            for kind in ("npy", "czi"):
                os.makedirs(os.path.join(kind, "stacks"))
                os.chdir(kind)
                _write_probe_design("probes.csv", codebook7)
                for laser, (lo, hi), r in zip(LASERS_7B, SEVEN_BIT.blocks,
                                              VOLUME_ROLLS):
                    stack = np.ascontiguousarray(np.moveaxis(np.roll(
                        cube[..., lo:hi], r, (0, 1, 2)), 2, 0))
                    if kind == "npy":
                        np.save(f"stacks/vol_{laser}.npy", stack)
                    else:
                        czi.write_czi(f"stacks/vol_{laser}.czi", stack)
                kernels.reset_launches()
                t0 = time.time()
                cli_biofilm.main(["stacks", "-p", "probes.csv", "-r",
                                  fixture_7b, "-d", "3"])
                torch.cuda.synchronize()
                runs[kind] = (time.time() - t0, kernels.launch_counts())
                os.chdir(tmp)
            path_d = check_path("(d)")
            inputs = {f"vol_{laser}.npy" for laser in LASERS_7B}
            made = sorted(set(os.listdir("npy/stacks")) - inputs)
            same = [f for f in made
                    if open(f"npy/stacks/{f}", "rb").read()
                    == open(f"czi/stacks/{f}", "rb").read()]
            with open("czi/stacks/vol_cell_information.csv") as f:
                n_d = len(f.read().splitlines()) - 1
            bytes_d = written()
            print(f"phase 19 (d) cli.biofilm -d 3 on 96x64x32 CZI z-stacks "
                  f"({path_d[0]} path): {runs['czi'][0]:.2f} s, {n_d} cells, "
                  f"{len(same)} of {len(made)} artifacts byte-identical to "
                  f"the .npy run's ({runs['npy'][0]:.2f} s); launches "
                  f"{runs['czi'][1]}")
            if len(same) != len(made) or len(made) < 8:
                raise AssertionError(f"phase 19 (d): artifacts differ: "
                                     f"{sorted(set(made) - set(same))}")
            missing = [k for k in PATH_BIOFILM_3D if not runs["czi"][1][k]]
            if missing:
                raise AssertionError(f"kernels not launched by 19 (d): "
                                     f"{missing}")
            out["d"] = {"seconds": runs["czi"][0], "n_cells": n_d,
                        "artifacts": made, "launches": runs["czi"][1]}
        finally:
            os.chdir(cwd)
    out["bytes_written"] = bytes_a + bytes_b + bytes_c + bytes_d
    out["seconds"] = time.time() - t_phase
    print(f"phase 19: {out['seconds']:.1f} s (budget "
          f"{READER_MAX_SECONDS:.0f} s), {out['bytes_written']} bytes "
          f"written (at most {READER_MAX_BYTES:.0e})")
    if out["bytes_written"] > READER_MAX_BYTES:
        raise AssertionError("phase 19 wrote more than its disk budget")
    return out


def _legacy_phase(torch, kernels, planes: str, dev) -> dict:
    """Phase 20: the reference's legacy UMAP stacks on the card, in a
    temporary directory that is removed afterwards; ``planes`` holds phase
    14's measured files, truth labels and warm-call artifacts."""
    import shutil

    from hiprfish_tpu_torch.cli import classify as cli_classify
    from hiprfish_tpu_torch.cli import classify_spectra as cli_spectra
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
    from hiprfish_tpu_torch.models import umap_infer
    from hiprfish_tpu_torch.models.artifacts import TorchRbfSvc
    from hiprfish_tpu_torch.pipeline import classify as pclassify
    from hiprfish_tpu_torch.utils import legacy_stacks, synthetic

    t_phase = time.time()
    out, written = {}, 0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            runs = (
                ("10b", TEN_BIT, "ecoli_enc_5", "_avgint.csv",
                 synthetic.ECOLI_CODES, False, cli_classify.main,
                 lambda f, t: [f, "-rf", t], "classify_ecoli_legacy"),
                ("7b", SEVEN_BIT, "flagship", "_avgint_norm.csv",
                 synthetic.FLAGSHIP_CODES, True, cli_spectra.main,
                 lambda f, t: ["-i", f, "-r", t],
                 "classify_spectra_7b_legacy"))
            for (tag, layout, sample, suffix, cell_codes, table, main,
                 argv, entry) in runs:
                # (a), (b): the stack at the reference's training width
                t0 = time.time()
                stack = legacy_stacks.reference_stack(layout, LEGACY_SPC)
                build_s = time.time() - t0
                rows, cols = stack.umap._raw_data.shape
                check_acc, chunk = [], 1 << 19
                t0 = time.time()
                for i, (chk, inputs) in enumerate(zip(stack.checks,
                                                      stack.check_rows)):
                    svc = TorchRbfSvc.from_pickled(chk, dev)
                    want = np.repeat(stack.check_bits[:, i], LEGACY_SPC)
                    good = sum(int((svc.predict(inputs[lo:lo + chunk])
                                    == want[lo:lo + chunk]).sum())
                               for lo in range(0, rows, chunk))
                    check_acc.append(good / rows)
                check_s = time.time() - t0
                t0 = time.time()
                files = legacy_stacks.write_stack(stack, ".", f"ref{tag}")
                stack_write_s = time.time() - t0
                written += sum(files.values())
                transform = next(iter(files))
                del stack
                print(f"phase 20 {tag} stack: {rows} x {cols} training rows "
                      f"(built {build_s:.2f} s), {len(files)} pickles "
                      f"{sum(files.values())} bytes written in "
                      f"{stack_write_s:.2f} s; check SVCs on the training "
                      f"rows {[round(a, 6) for a in check_acc]} "
                      f"({check_s:.2f} s)")
                if min(check_acc) < 0.99:
                    raise AssertionError(f"phase 20 {tag}: a check SVC "
                                         f"scores below 0.99 on its rows")
                for name in (sample + suffix, sample + "_seg.npy"):
                    shutil.copy(os.path.join(planes, name), name)
                truth = np.load(os.path.join(planes, f"{sample}_truth.npy"))
                turns, prev = {}, None
                orig = getattr(pclassify, entry)
                for turn in ("cold", "warm"):
                    stages = {}
                    setattr(pclassify, entry,
                            lambda *a, **kw: orig(*a, timings=stages, **kw))
                    kernels.reset_launches()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.time()
                    try:
                        main(argv(sample + suffix, transform))
                    finally:
                        setattr(pclassify, entry, orig)
                    torch.cuda.synchronize()
                    total = time.time() - t0
                    launches = kernels.launch_counts()
                    seg, codebook, idx = _artifact_calls(sample, table)
                    n_found = len(codebook) - 1
                    correct, matched = _barcode_accuracy(
                        seg, truth, idx, cell_codes, codebook, layout,
                        n_found, n_found + 1)
                    acc = correct / max(matched, 1)
                    names = ([f"{sample}_cell_information.csv"] if table
                             else [f"{sample}_cell_ids.txt",
                                   f"{sample}_avgint_ids.csv",
                                   f"{sample}_identification.png"])
                    digests = _digests(names)
                    turns[turn] = {
                        "n_cells": n_found, "matched": matched,
                        "accuracy": acc, "total_s": total,
                        "stages_s": stages, "launches": launches,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2**30}
                    print(f"phase 20 {tag} cli {turn}: n_cells {n_found}, "
                          f"matched {matched}, accuracy {acc:.4f} "
                          f"({correct}/{matched}) from the artifacts; "
                          f"{total:.2f} s (" + ", ".join(
                              f"{k} {v:.3f}" for k, v in stages.items())
                          + f"); peak {turns[turn]['peak_gib']:.3f} GiB; "
                          f"launches {launches}")
                    if matched < 380 or acc < 0.99:
                        raise AssertionError(
                            f"phase 20 {tag}: {correct}/{matched} matched "
                            "cells correct, expected >= 0.99 of >= 380")
                    if any(launches.values()):
                        raise AssertionError(f"phase 20 {tag}: a kernel "
                                             f"launched: {launches}")
                    if prev is not None and digests != prev:
                        raise AssertionError(f"phase 20 {tag}: the warm "
                                             "call wrote other artifacts")
                    prev = digests
                out[tag] = {"rows": rows, "columns": cols,
                            "check_accuracy": check_acc,
                            "stack_bytes": sum(files.values()),
                            "build_s": build_s, **turns}
                for name in os.listdir("."):
                    os.remove(name)
            out["c"] = _legacy_cpu_vs_card(torch, dev, planes)
            written += out["c"]["stack_bytes"]
            out["d"] = _legacy_fixture(torch, dev)
        finally:
            os.chdir(cwd)
    out["seconds"] = time.time() - t_phase
    out["bytes_written"] = written
    print(f"phase 20: {out['seconds']:.1f} s, {written} bytes written")
    if written > LEGACY_MAX_BYTES or out["seconds"] > LEGACY_MAX_SECONDS:
        raise AssertionError("phase 20: past its time or disk budget")
    return out


def _legacy_cpu_vs_card(torch, dev, planes: str) -> dict:
    """Phase 20 (c): the small 10-bit synthetic stack of the CPU tests on
    the CPU and on the card, on phase 14's measured 10-bit features, with
    the same negative draws."""
    from hiprfish_tpu_torch.config import TEN_BIT
    from hiprfish_tpu_torch.io import outputs
    from hiprfish_tpu_torch.models import umap_infer
    from hiprfish_tpu_torch.utils import legacy_stacks

    stack = legacy_stacks.reference_stack(TEN_BIT, LEGACY_SMALL_SPC)
    files = legacy_stacks.write_stack(stack, ".", "small")
    path = next(iter(files))
    avg = outputs.read_spectra_csv(os.path.join(planes,
                                                "ecoli_enc_5_avgint.csv"))
    norm = avg / np.maximum(avg.max(axis=1, keepdims=True), 1e-12)
    feats = np.concatenate([norm, np.zeros((len(norm), 37))], axis=1)
    feats[:, 95:126] = np.diff(feats[:, :32], axis=1)
    card = umap_infer.load_legacy_umap_stack(path, device=dev)
    cpu = umap_infer.load_legacy_umap_stack(path, device="cpu")
    n_train = card.umap.raw_data.shape[0]
    negs = torch.randint(0, n_train, (30, len(feats), 5),
                         generator=torch.Generator().manual_seed(0))
    res = {}
    for name, s, d in (("card", card, dev), ("cpu", cpu, "cpu")):
        codes, x = s.predict(feats, negatives=negs, return_checks=True)
        emb, idx, dist = umap_infer.transform_full(
            s.umap, x, s.distance_fn, negatives=negs, device=d)
        res[name] = (codes, x, emb.cpu(), idx.cpu(), dist.cpu())
    c, g = res["cpu"], res["card"]
    # the embedded SVC on the same (the CPU's) embedding
    dec = [s.svc_embed.decision_function_ovo(c[2]).cpu() for s in (cpu,
                                                                  card)]
    out = {"rows": n_train, "queries": len(feats),
           "stack_bytes": sum(files.values()),
           "checks_equal": bool(np.array_equal(c[1], g[1])),
           "calls_equal": bool(np.array_equal(c[0], g[0])),
           "neighbours_equal": bool(torch.equal(c[3], g[3])),
           "distance_err": float((c[4] - g[4]).abs().max()),
           "embedding_err": float((c[2] - g[2]).abs().max()),
           "decision_err": float((dec[0] - dec[1]).abs().max())}
    print(f"phase 20 (c) {n_train}-row 10-bit stack, {len(feats)} measured "
          f"cells, cpu vs card: {out}")
    if not (out["checks_equal"] and out["calls_equal"]
            and out["neighbours_equal"]) or out["distance_err"] > 2e-6 \
            or out["embedding_err"] > 1e-4 or out["decision_err"] > 1e-5:
        raise AssertionError("phase 20 (c): the card disagrees with the CPU")
    return out


def _legacy_fixture(torch, dev) -> dict:
    """Phase 20 (d): the committed real-sklearn stacks
    (tools/make_torch_legacy_fixture.py) scored on the card without
    sklearn: sklearn's stored predictions exactly, predict_proba within
    5e-3, the held-out codes."""
    from hiprfish_tpu_torch.models import umap_infer

    t0 = time.time()
    answers = np.load(os.path.join(LEGACY_FIXTURES, "answers.npz"))
    out = {}
    for tag, name, load in (
            ("10b", "ref10_umap_transform.pkl",
             umap_infer.load_legacy_umap_stack),
            ("7b", "ref7_umap_transform_biofilm_7b.pkl",
             umap_infer.load_legacy_umap_stack_7b)):
        stack = load(os.path.join(LEGACY_FIXTURES, name), device=dev)
        q = answers[f"queries_{tag}"]
        xs = stack.check_inputs(torch.from_numpy(q).to(dev))
        checks_equal = all(
            np.array_equal(svc.predict(xs[:, lo:hi]),
                           answers[f"check_pred_{tag}"][i])
            for i, (svc, (lo, hi)) in enumerate(zip(stack.check_svcs,
                                                    stack.blocks)))
        pts = answers[f"embed_points_{tag}"]
        embed_equal = bool(np.array_equal(
            stack.svc_embed.predict(pts).astype(str),
            answers[f"embed_pred_{tag}"]))
        proba_err = float(np.abs(stack.svc_embed.predict_proba(pts)
                                 - answers[f"embed_proba_{tag}"]).max())
        acc = float(np.mean(np.asarray(stack.predict(q)).astype(str)
                            == answers[f"labels_{tag}"]))
        out[tag] = {"checks_equal": checks_equal, "embed_equal": embed_equal,
                    "proba_err": proba_err, "held_out_accuracy": acc}
        print(f"phase 20 (d) {tag} real-sklearn stack: {out[tag]}")
        if not (checks_equal and embed_equal) or proba_err > 5e-3 \
                or acc < 0.99:
            raise AssertionError(f"phase 20 (d) {tag}: not sklearn's "
                                 "answers")
    out["seconds"] = time.time() - t0
    return out


# phase 21: the scale-out. The 3D sweep's tiling of 16a's 96 x 64 x 32
# volume (four tiles, cells narrower than the margin) and phase 7's
# KMeans iterations; the rows of the data-parallel check head (one batch
# of train_check_heads, so both take the same full-batch step), its steps
# and rate; B5's contract twice over (each side's sums within 2^-16 of
# the exact ones); (c)'s headroom over the batch of two's peak; the
# process-group timeout and the bound on each spawned world's run
SCALE_TILED = dict(max_cells=64, tile_x=24, margin=16, tile_cap=64,
                   bf16=True)
SCALE_KMEANS = 20
SCALE_ROWS = 4096
SCALE_STEPS = 20
SCALE_LR = 3e-3
SCALE_TRAIN_TOL = 1e-5
SCALE_MEASURE_RTOL = 2.0 ** -15
# two runs' spectra CSVs: each mean's sums within 2^-16 of the exact ones,
# and the row maximum of the normalised spectra as well
SCALE_CSV_RTOL = 2.0 ** -14
OOM_MARGIN = 512 * 2**20
SCALE_TIMEOUT_S = 300
# phase 22: in-tile seeds, their out-of-memory fallback, the warm-up
# command and the stencil forms. (b) caps the memory only where the
# global seed stage's peak stands at least INTILE_CAP_GAP above every
# stage of the in-tile run (else a ballast fills the card inside
# _global_seeds); the ballast's chunk sizes, each allocated until the
# allocator refuses (the last is below (b)'s first allocation in
# _global_seeds, a 96 x 32 x 64 bool mask); (c)'s command; (d)'s (X, Z, Y)
# sub-volume of the 3D fixture and its 2D image side
INTILE_CAP_GAP = 256 * 2 ** 20
BALLAST_CHUNKS = (2 ** 30, 64 * 2 ** 20, 2 * 2 ** 20, 128 * 2 ** 10)
WARMUP_ARGV = ("-m", "hiprfish_tpu_torch.cli.warmup", "--family", "ecoli",
               "multispecies", "3d", "--size", "2000")
STENCIL_3D = (64, 170, 64)
STENCIL_2D = 512


def _scale_inputs(torch, kernels, dev, refs: dict, tmp: str) -> dict:
    """Phase 21's inputs and one-card references, written to ``tmp`` for
    the spawned ranks: phases 5 and 11's labels and calls, B2 on the whole
    2000^2 image, the host sweep of 16a's volume and its streamed
    measurement (B5), and train_check_heads on SCALE_ROWS rows."""
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models import classifier
    from hiprfish_tpu_torch.pipeline import segment3d

    img = _smooth_image((2000, 2000), 21)
    lpcv = kernels.lpcv2d(torch.from_numpy(img).to(dev), 11, 9).cpu().numpy()
    cube = _volume_stack([1, 9, 65, 127, 3, 5, 17, 33, 64], (96, 64, 32))
    vol_sum = cube.sum(axis=3)
    cube_cm = np.ascontiguousarray(cube.transpose(3, 2, 0, 1))
    del cube
    seg3d, n3d, _ = segment3d.segment_3d_tiled(
        torch.from_numpy(vol_sum).to(dev),
        SegmentationConfig(kmeans_iters=SCALE_KMEANS), **SCALE_TILED)
    cm_dev = torch.from_numpy(cube_cm).to(dev)
    spectra = segment3d.measure_volume_streamed(
        seg3d, lambda z0, zc: cm_dev[:, z0:z0 + zc], vol_sum.shape[2], 8,
        cube_cm.shape[0], SCALE_TILED["max_cells"], channels_major=True)
    rng = np.random.RandomState(21)
    x = rng.rand(SCALE_ROWS, 23).astype(np.float32)
    y = (x.mean(1) > 0.5).astype(np.float32)
    init = {"w1": (rng.randn(23, 32) * np.sqrt(2.0 / 23)).astype(np.float32),
            "b1": np.zeros(32, np.float32),
            "w2": (rng.randn(32, 1) * np.sqrt(1.0 / 32)).astype(np.float32),
            "b2": np.zeros(1, np.float32)}
    one = classifier.train_check_heads(
        torch.from_numpy(x).to(dev)[None], torch.from_numpy(y).to(dev)[None],
        {k: torch.from_numpy(v).to(dev)[None] for k, v in init.items()},
        torch.arange(SCALE_ROWS, device=dev)[None], SCALE_STEPS, SCALE_LR)
    out = dict(img=img, lpcv=lpcv, vol_sum=vol_sum, cube_cm=cube_cm,
               seg3d=seg3d.cpu().numpy(), n3d=np.int64(n3d),
               spectra=spectra.cpu().numpy(), x=x, y=y,
               **{f"init_{k}": v for k, v in init.items()},
               **{f"one_{k}": v[0].cpu().numpy() for k, v in one.items()},
               **refs)
    np.savez(os.path.join(tmp, "inputs.npz"), **out)
    return out


def _scale_checks(torch, kernels, mesh_f, mesh_t, planes: str,
                  inp: dict, copies: int = 2) -> dict:
    """Phase 21's checks on one rank of a world: the 'fov' mesh mesh_f
    carries the batched steps (over ``copies`` copies of each FOV), the 3D
    sweep, the z-sharded measurement and the check-head training; the
    'tile' mesh mesh_t the row-sharded LP-CV. Each path's launches are counted from zero; every equality is
    held here, so a rank that disagrees fails its world."""
    import torch.distributed as dist

    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import fov_batch, spatial
    from hiprfish_tpu_torch.parallel import mesh as meshlib
    from hiprfish_tpu_torch.pipeline import fused, segment3d

    dev = meshlib.mesh_device(mesh_f)
    cfg = SegmentationConfig()
    out = {}

    def timed(name, fn, path, n_fovs=None):
        """fn() twice (cold, warm), each with its launches (counted from
        zero) and its seconds, the world's ranks starting together; ms per
        FOV over n_fovs. Returns the cold call's result."""
        out[name] = {}
        for turn in ("", " warm"):
            dist.barrier(group=mesh_f.get_group("fov"))
            kernels.reset_launches()
            t0 = time.time()
            got = fn()
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches = kernels.launch_counts()
            missing = [k for k in path if launches[k] == 0]
            if missing:
                raise AssertionError(f"phase 21 {name}: kernels not "
                                     f"launched {missing}")
            out[name].update({"seconds" + turn: seconds,
                              "launches" + turn: launches})
            if n_fovs:
                out[name]["ms_per_fov" + turn] = seconds * 1000 / n_fovs
            if turn == "":
                res = got
            del got
        return res

    # the batched steps over two copies of each 2000^2 FOV
    for name, layout_planes, clf_path, path, key in (
            ("batched_fov_step", [f"flagship_{la}.npy" for la in LASERS_7B],
             FIXTURE, PATH_2D, "ref5"),
            ("batched_fov_step_ecoli",
             [f"ecoli_enc_5_{la}.npy" for la in LASERS_10B], FIXTURE_10B,
             PATH_ECOLI, "ref11")):
        planes_np = [np.load(os.path.join(planes, f)) for f in layout_planes]
        stack = tuple([p] * copies for p in planes_np)
        arrays, static = fused.classifier_from_numpy(
            load_classifier(clf_path), dev)
        make = (fov_batch.batched_fov_step if name == "batched_fov_step"
                else fov_batch.batched_fov_step_ecoli)
        run = make(mesh_f, cfg, MAX_CELLS, static)
        res = timed(name, lambda: run(stack, arrays), path, copies)
        seg, n_cells, code_idx = ((res.segmentation, res.n_cells,
                                   res.code_idx) if name == "batched_fov_step"
                                  else (res[0], res[1], res[3]))
        n_ref = int(inp[f"{key}_n"])
        for i in range(copies):
            n = int(n_cells[i])
            if n != n_ref or not np.array_equal(
                    seg[i].cpu().numpy(), inp[f"{key}_seg"]) \
                    or not np.array_equal(code_idx[i, 1:n + 1].cpu().numpy(),
                                          inp[f"{key}_codes"]):
                raise AssertionError(f"phase 21 {name}: FOV {i} differs "
                                     "from the single-FOV step")
        del planes_np, stack, res, seg
        torch.cuda.empty_cache()

    # LP-CV over row shards: bitwise B2 on the whole image
    got = timed("lp_cv_enhance_2d_sharded", lambda: spatial
                .lp_cv_enhance_2d_sharded(inp["img"], mesh_t), ("lpcv2d",))
    if not np.array_equal(got.cpu().numpy(), inp["lpcv"]):
        raise AssertionError("phase 21 lp_cv_enhance_2d_sharded: not B2's "
                             "bits on the whole image")
    # the 3D sweep over the mesh: the host sweep's labels
    seg3d, n3d, _ = timed(
        "segment_3d_tiled mesh", lambda: segment3d.segment_3d_tiled(
            torch.from_numpy(inp["vol_sum"]).to(dev),
            SegmentationConfig(kmeans_iters=SCALE_KMEANS), mesh=mesh_f,
            **SCALE_TILED), ("label_stats", "label_lookup", "lpcv3d"))
    if n3d != int(inp["n3d"]) or not np.array_equal(seg3d.cpu().numpy(),
                                                    inp["seg3d"]):
        raise AssertionError("phase 21 segment_3d_tiled(mesh=): labels "
                             "differ from the host sweep")
    # z-slabs per rank: measure_volume_streamed's spectra within B5's
    # contract twice over
    spectra = timed("measure_volume_zsharded", lambda: segment3d
                    .measure_volume_zsharded(
                        inp["seg3d"], inp["cube_cm"], mesh_f, "fov",
                        SCALE_TILED["max_cells"]), ("stats_cm",)).cpu().numpy()
    err = float(np.abs(spectra - inp["spectra"]).max())
    if not np.allclose(spectra, inp["spectra"], rtol=SCALE_MEASURE_RTOL,
                       atol=1e-6):
        raise AssertionError(f"phase 21 measure_volume_zsharded: {err} "
                             "from measure_volume_streamed")
    out["measure_volume_zsharded"]["max_abs_err"] = err
    # the data-parallel check head: train_check_heads' full-batch step
    init = {k: inp[f"init_{k}"] for k in ("w1", "b1", "w2", "b2")}
    params = timed("train_check_heads_dp", lambda: fov_batch
                   .train_check_heads_dp(mesh_f, inp["x"], inp["y"], init,
                                         SCALE_STEPS, SCALE_LR), ())
    err = max(float(np.abs(params[k] - inp[f"one_{k}"].reshape(
        params[k].shape)).max()) for k in params)
    if err > SCALE_TRAIN_TOL:
        raise AssertionError(f"phase 21 train_check_heads_dp: {err} from "
                             "train_check_heads")
    out["train_check_heads_dp"]["max_abs_err"] = err
    return out


def _scale_rank(rank: int, world: int, tmp: str, planes: str) -> None:
    """One spawned rank of phase 21 (b): join the world over the
    HIPRFISH_* contract (gloo: the ranks share the card), run the checks,
    then run_distributed_pipeline over the 7-bit planes as four samples;
    the results go to tmp/rank<r>.json."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    os.environ.update(HIPRFISH_COORDINATOR=f"file://{tmp}/pg_b",
                      HIPRFISH_NUM_PROCESSES=str(world),
                      HIPRFISH_PROCESS_ID=str(rank))
    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import distributed
    from hiprfish_tpu_torch.parallel import mesh as meshlib

    timeout = timedelta(seconds=SCALE_TIMEOUT_S)
    distributed.initialize_from_env(timeout)
    if dist.get_backend() != "gloo":
        raise AssertionError("phase 21 (b): ranks sharing one card must "
                             f"join over gloo, got {dist.get_backend()}")
    mesh_f = meshlib.make_mesh(fov=world, tile=1, timeout=timeout)
    mesh_t = meshlib.make_mesh(fov=1, tile=world, timeout=timeout)
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = _scale_checks(torch, kernels, mesh_f, mesh_t, planes, inp)
    files = [os.path.join(planes, f"flagship_{la}.npy") for la in LASERS_7B]
    samples = [(f"s{i}", files) for i in range(4)]
    dist.barrier()
    kernels.reset_launches()
    t0 = time.time()
    got = distributed.run_distributed_pipeline(
        samples, load_classifier(FIXTURE), out_dir=os.path.join(tmp, "b"))
    torch.cuda.synchronize()
    out["run_distributed_pipeline"] = {
        "seconds": time.time() - t0, "launches": kernels.launch_counts(),
        "samples": list(got)}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _oom_rank(tmp: str, planes: str) -> None:
    """Phase 21 (c) in a spawned process of its own: the 7-bit planes as
    four samples through run_batch_pipeline on a (1, 1) mesh (NCCL, world
    1): uncapped at batch 2 (its peak reserved memory measured), then at
    batch 4 under a per-process memory fraction of that peak plus
    OOM_MARGIN. The results go to tmp/oom.json."""
    import logging
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    os.environ.update(HIPRFISH_COORDINATOR=f"file://{tmp}/pg_c",
                      HIPRFISH_NUM_PROCESSES="1", HIPRFISH_PROCESS_ID="0")
    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import distributed, fov_batch
    from hiprfish_tpu_torch.parallel import mesh as meshlib
    from hiprfish_tpu_torch.utils import oom

    timeout = timedelta(seconds=SCALE_TIMEOUT_S)
    distributed.initialize_from_env(timeout)
    mesh = meshlib.make_mesh(fov=1, tile=1, timeout=timeout)
    files = [os.path.join(planes, f"flagship_{la}.npy") for la in LASERS_7B]
    samples = [(f"c{i}", files) for i in range(4)]
    clf = load_classifier(FIXTURE)
    out = {"backend": dist.get_backend()}

    def run(batch, name, fovs):
        os.makedirs(os.path.join(tmp, name))
        kernels.reset_launches()
        t0 = time.time()
        fov_batch.run_batch_pipeline(fovs, clf, batch=batch, mesh=mesh,
                                     out_dir=os.path.join(tmp, name))
        torch.cuda.synchronize()
        out[name] = {"seconds": time.time() - t0,
                     "ms_per_fov": (time.time() - t0) * 1000 / len(fovs),
                     "launches": kernels.launch_counts()}

    run(1, "warm", samples[:1])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run(2, "uncapped", samples)
    peak = torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction((peak + OOM_MARGIN) / total)
    warnings = []
    handler = logging.Handler()
    handler.emit = lambda rec: warnings.append(rec.getMessage())
    oom.log.addHandler(handler)
    run(4, "capped", samples)
    oom.log.removeHandler(handler)
    out.update(peak_batch2=peak, cap=peak + OOM_MARGIN, total=total,
               splits=warnings)
    with open(os.path.join(tmp, "oom.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _spawn(targets) -> None:
    """Run each (function, args) in a spawned process, all at once; fail
    if one fails or outlives SCALE_TIMEOUT_S, and leave none running."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=args) for fn, args in targets]
    for p in procs:
        p.start()
    deadline = time.time() + SCALE_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.time(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"spawned processes ended {codes}")


def _rows_close(u: str, v: str) -> bool:
    """Two CSV rows of numbers within SCALE_CSV_RTOL."""
    try:
        return bool(np.allclose(np.array(u.split(","), float),
                                np.array(v.split(","), float),
                                rtol=SCALE_CSV_RTOL, atol=0))
    except ValueError:
        return False


def _artifacts_differ(a: str, b: str) -> list:
    """The artifact names of directory ``a`` that ``b`` lacks or holds
    otherwise: labels and calls byte for byte, the spectra CSVs (whose
    sums are B3's float atomics, within 2^-16 relative in every run) within
    SCALE_CSV_RTOL."""
    bad = []
    for name in sorted(os.listdir(a)):
        pb = os.path.join(b, name)
        if not os.path.exists(pb):
            bad.append(name)
            continue
        with open(os.path.join(a, name), "rb") as f:
            want = f.read()
        with open(pb, "rb") as f:
            got = f.read()
        if name.endswith(".csv"):
            lines = [t.decode().splitlines() for t in (want, got)]
            same = len(lines[0]) == len(lines[1]) and all(
                u == v or _rows_close(u, v) for u, v in zip(*lines))
        else:
            same = got == want
        if not same:
            bad.append(name)
    return bad


def _scaleout_phase(torch, kernels, planes: str, refs: dict, dev) -> dict:
    """Phase 21: the scale-out over torch.distributed on the card, in a
    temporary directory that is removed afterwards. ``planes`` holds phase
    14's planes; ``refs`` phases 5 and 11's labels and calls. (a) world 1
    over NCCL in this process, (b) world 2 of two spawned ranks sharing the
    card over gloo, (c) an allocator OOM taken by the batch halving."""
    import torch.distributed as dist

    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import distributed, fov_batch
    from hiprfish_tpu_torch.parallel import mesh as meshlib

    t_phase = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        inp = _scale_inputs(torch, kernels, dev, refs, tmp)
        print(f"phase 21 inputs and one-card references: "
              f"{time.time() - t_phase:.1f} s")
        # (a) world 1 over NCCL, through the HIPRFISH_* contract
        env = {k: os.environ.get(k) for k in (
            "HIPRFISH_COORDINATOR", "HIPRFISH_NUM_PROCESSES",
            "HIPRFISH_PROCESS_ID")}
        os.environ.update(HIPRFISH_COORDINATOR=f"file://{tmp}/pg_a",
                          HIPRFISH_NUM_PROCESSES="1",
                          HIPRFISH_PROCESS_ID="0")
        try:
            from datetime import timedelta

            timeout = timedelta(seconds=SCALE_TIMEOUT_S)
            distributed.initialize_from_env(timeout)
            backend = dist.get_backend()
            if backend != "nccl":
                raise AssertionError(f"phase 21 (a): a rank with a card of "
                                     f"its own must join over NCCL, got "
                                     f"{backend}")
            mesh = meshlib.make_mesh(fov=1, tile=1, timeout=timeout)
            out["world 1"] = _scale_checks(torch, kernels, mesh, mesh,
                                           planes, inp)
            dist.destroy_process_group()
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _print_world("(a) world 1, nccl", out["world 1"])
        # (b) world 2 on the one card over gloo; the reference artifacts
        # of run_distributed_pipeline: run_batch_pipeline in this process
        files = [os.path.join(planes, f"flagship_{la}.npy")
                 for la in LASERS_7B]
        for d in ("one", "b"):
            os.makedirs(os.path.join(tmp, d))
        fov_batch.run_batch_pipeline([(f"s{i}", files) for i in range(4)],
                                     load_classifier(FIXTURE),
                                     out_dir=os.path.join(tmp, "one"))
        del inp
        torch.cuda.empty_cache()
        t0 = time.time()
        _spawn([(_scale_rank, (r, 2, tmp, planes)) for r in range(2)])
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        bad = _artifacts_differ(os.path.join(tmp, "one"),
                                os.path.join(tmp, "b"))
        if bad or sorted(ranks[0]["run_distributed_pipeline"]["samples"]
                         + ranks[1]["run_distributed_pipeline"]["samples"]) \
                != [f"s{i}" for i in range(4)]:
            raise AssertionError(f"phase 21 (b) run_distributed_pipeline: "
                                 f"artifacts differ {bad}")
        world2 = {}
        for name in ranks[0]:
            world2[name] = {
                "seconds": max(r[name]["seconds"] for r in ranks),
                "launches": {k: sum(r[name]["launches"][k] for r in ranks)
                             for k in ranks[0][name]["launches"]},
                "ranks": [r[name] for r in ranks]}
            for k in ("seconds warm", "ms_per_fov", "ms_per_fov warm"):
                if k in ranks[0][name]:
                    world2[name][k] = max(r[name][k] for r in ranks)
        out["world 2"] = world2
        out["world 2"]["wall_s"] = time.time() - t0
        _print_world("(b) world 2 on one card, gloo", world2)
        # (c) a real allocator OOM, halved
        t0 = time.time()
        _spawn([(_oom_rank, (tmp, planes))])
        with open(os.path.join(tmp, "oom.json")) as f:
            oom_out = json.load(f)
        bad = _artifacts_differ(os.path.join(tmp, "uncapped"),
                          os.path.join(tmp, "capped"))
        oom_out["wall_s"] = time.time() - t0
        print(f"phase 21 (c) run_batch_pipeline over a (1, 1) mesh "
              f"({oom_out['backend']}): batch 2 uncapped "
              f"{oom_out['uncapped']['ms_per_fov']:.1f} ms/FOV, peak "
              f"reserved {oom_out['peak_batch2'] / 2**30:.3f} GiB; batch 4 "
              f"capped at {oom_out['cap'] / 2**30:.3f} of "
              f"{oom_out['total'] / 2**30:.2f} GiB: "
              f"{oom_out['capped']['ms_per_fov']:.1f} ms/FOV, splits "
              f"{oom_out['splits']}, launches "
              f"{oom_out['capped']['launches']}; artifacts differ {bad}")
        if bad or not oom_out["splits"]:
            raise AssertionError("phase 21 (c): no OOM was taken by the "
                                 "halving, or the artifacts differ")
        missing = [k for k in PATH_2D
                   if oom_out["capped"]["launches"][k] == 0]
        if missing:
            raise AssertionError(f"phase 21 (c): kernels not launched "
                                 f"{missing}")
        out["oom"] = oom_out
    out["seconds"] = time.time() - t_phase
    print(f"phase 21: {out['seconds']:.1f} s")
    return out


def _print_world(tag: str, res: dict) -> None:
    """One line per path of a world: seconds (cold and, where timed,
    warm), ms per FOV, error against the one-card result, launches."""
    for name, r in res.items():
        if not isinstance(r, dict):
            continue
        extra = ""
        if "seconds warm" in r:
            extra = f" cold, {r['seconds warm']:.3f} s warm"
        if "ms_per_fov" in r:
            extra += (f"; {r['ms_per_fov']:.1f} ms/FOV cold, "
                      f"{r['ms_per_fov warm']:.1f} warm")
        if "max_abs_err" in r:
            extra += f"; max_abs_err {r['max_abs_err']:.3e}"
        print(f"phase 21 {tag} {name}: {r['seconds']:.3f} s{extra}; "
              f"launches {r['launches']}")


def _in_tile_phase(torch, dev, clf, ref8: dict) -> dict:
    """Phase 22 (a): phase 8's pass with global_seeds=False (each tile
    seeds its own slab), launches counted from zero: labels byte-identical
    to phase 8's, the same n_cells, the bars of phase 8."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.utils import synthetic
    from hiprfish_tpu_torch.utils import synthetic3d as s3

    spec = s3.VolumeSpec(shape=SHAPE_3D, spacing=(36, 36, 52), seed=5)
    lut_dev = torch.from_numpy(np.stack([
        synthetic.barcode_spectrum(SEVEN_BIT, c)
        for c in range(1, 128)]).astype(np.float32)).to(dev)
    torch.cuda.empty_cache()
    r = _volume_pass(torch, dev, spec, lut_dev, clf, SegmentationConfig(),
                     dict(TILED_3D, global_seeds=False), MAX_CELLS_3D,
                     tag="phase 22a", keep_labels=True)
    seg = r.pop("seg_xzy")
    equal = bool(torch.equal(seg, ref8["seg_xzy"]))
    differ = 0 if equal else int((seg != ref8["seg_xzy"]).sum())
    del seg
    n, matched, correct = r["n_cells"], r["matched"], r["correct"]
    acc = correct / max(matched, 1)
    print(f"phase 22a in-tile seeds {SHAPE_3D}: n_cells {n} (global seeds "
          f"{ref8['n_cells']}, planted {spec.n_cells}), labels "
          f"byte-identical {equal} ({differ} voxels differ), matched "
          f"{matched}, accuracy {acc:.4f} ({correct}/{matched}); "
          f"{r['total']:.2f} s (global seeds {ref8['total']:.2f} s); "
          f"launches {r['launches']}")
    print(f"phase 22a stage peaks (GiB): {r['stage_peaks_text']}; global "
          f"seeds' (phase 8): {ref8['stage_peaks_text']}")
    missing = [k for k in PATH_3D if r["launches"][k] == 0]
    if not equal or n != ref8["n_cells"] or missing:
        raise AssertionError(f"phase 22a: in-tile seeds differ from the "
                             f"global seeds or kernels not launched "
                             f"{missing}")
    if n != spec.n_cells or matched < 9300 or acc < 0.99:
        raise AssertionError("phase 22a: n_cells != 9408, or accuracy below "
                             "0.99, or fewer than 9300 matched cells")
    r["accuracy"] = acc
    r["labels_equal"] = equal
    return r


def _fill_device(torch, dev) -> list:
    """Tensors that hold the card's free memory: chunks of each of
    BALLAST_CHUNKS allocated until the allocator refuses one."""
    ballast = []
    for chunk in BALLAST_CHUNKS:
        while True:
            try:
                ballast.append(torch.empty(chunk, dtype=torch.uint8,
                                           device=dev))
            except torch.OutOfMemoryError:
                break
    return ballast


def _fallback_rank(tmp: str) -> None:
    """Phase 22 (b) in a spawned process of its own: segment_3d_tiled on
    16a's 96 x 64 x 32 volume with in-tile seeds and with global seeds,
    each stage's peak reserved memory read, then with global seeds under
    an allocator out-of-memory error inside _global_seeds: a memory cap
    between the in-tile run's highest stage and the global seed stage
    where those stand INTILE_CAP_GAP apart, else a ballast that fills the
    card as _global_seeds starts and is freed as the error leaves it. The
    results go to tmp/fallback.json."""
    import logging

    import torch

    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.pipeline import segment3d
    from hiprfish_tpu_torch.utils import oom

    dev = torch.device("cuda", 0)
    vol_sum = _volume_stack([1, 9, 65, 127, 3, 5, 17, 33, 64],
                            (96, 64, 32)).sum(axis=3)
    cfg = SegmentationConfig(kmeans_iters=SCALE_KMEANS)

    def run(**kw):
        peaks = {}

        def log(msg):
            key = "tiles" if msg.startswith("tile ") else msg.split(":")[0]
            torch.cuda.synchronize()
            peaks[key] = max(peaks.get(key, 0),
                             torch.cuda.max_memory_reserved())
            torch.cuda.reset_peak_memory_stats()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        seg, n, _ = segment3d.segment_3d_tiled(
            torch.from_numpy(vol_sum).to(dev), cfg, log=log, **kw,
            **SCALE_TILED)
        torch.cuda.synchronize()
        return {"seg": seg.cpu(), "n": n, "seconds": time.time() - t0,
                "peaks": peaks, "launches": kernels.launch_counts()}

    in_tile = run(global_seeds=False)
    run()  # warm
    glob = run()
    gap = glob["peaks"]["global seeds"] - max(in_tile["peaks"].values())
    total = torch.cuda.get_device_properties(0).total_memory
    original = segment3d._global_seeds
    raised = []

    def capped_seeds(*args):
        try:
            return original(*args)
        except BaseException as e:
            raised.append(type(e).__name__)
            raise

    def ballast_seeds(*args):
        torch.cuda.empty_cache()
        ballast = _fill_device(torch, dev)
        try:
            return original(*args)
        except BaseException as e:
            raised.append(type(e).__name__)
            raise
        finally:
            del ballast

    warnings = []
    handler = logging.Handler()
    handler.emit = lambda rec: warnings.append(rec.getMessage())
    oom.log.addHandler(handler)
    if gap >= INTILE_CAP_GAP:
        how = "cap"
        cap = max(in_tile["peaks"].values()) + gap / 2
        segment3d._global_seeds = capped_seeds
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(cap / total)
    else:
        how, cap = "ballast", None
        segment3d._global_seeds = ballast_seeds
    try:
        fell = run()
    finally:
        segment3d._global_seeds = original
        torch.cuda.set_per_process_memory_fraction(1.0)
        oom.log.removeHandler(handler)
    out = {"how": how, "cap": cap, "gap": gap, "raised": raised,
           "warnings": warnings, "n_in_tile": in_tile["n"],
           "n_global": glob["n"], "n_fallback": fell["n"],
           "fallback_equals_in_tile": bool(torch.equal(fell["seg"],
                                                       in_tile["seg"])),
           "global_equals_in_tile": bool(torch.equal(glob["seg"],
                                                     in_tile["seg"])),
           **{f"{k}_{name}": r[k] for name, r in (
               ("in_tile", in_tile), ("global", glob), ("fallback", fell))
              for k in ("seconds", "peaks", "launches")}}
    with open(os.path.join(tmp, "fallback.json"), "w") as f:
        json.dump(out, f)


def _fallback_phase() -> dict:
    """Phase 22 (b): _fallback_rank in a spawned process; the OOM must
    come from the allocator (torch.OutOfMemoryError raised in
    _global_seeds), the fallback's one warning must appear, and its labels
    must equal the in-tile run's."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        _spawn([(_fallback_rank, (tmp,))])
        with open(os.path.join(tmp, "fallback.json")) as f:
            out = json.load(f)
    out["seconds"] = time.time() - t0
    mib = {k: {s: round(v / 2 ** 20, 1) for s, v in out[k].items()}
           for k in ("peaks_in_tile", "peaks_global")}
    print(f"phase 22b OOM fallback on 96x64x32 ({out['how']}; gap of the "
          f"global seed stage over the in-tile run {out['gap'] / 2**20:.1f} "
          f"MiB): raised {out['raised']}, warnings {out['warnings']}, "
          f"n_cells in-tile / global / fallback {out['n_in_tile']} / "
          f"{out['n_global']} / {out['n_fallback']}, fallback labels equal "
          f"the in-tile labels {out['fallback_equals_in_tile']} (global "
          f"seeds' equal {out['global_equals_in_tile']}); seconds in-tile "
          f"{out['seconds_in_tile']:.3f} global {out['seconds_global']:.3f} "
          f"fallback {out['seconds_fallback']:.3f}; peaks reserved (MiB) "
          f"{mib}; launches {out['launches_fallback']}; phase "
          f"{out['seconds']:.1f} s")
    if out["raised"] != ["OutOfMemoryError"] \
            or out["warnings"] != ["global seeds OOM -> in-tile seeds"] \
            or not out["fallback_equals_in_tile"] \
            or out["n_fallback"] != out["n_in_tile"]:
        raise AssertionError("phase 22b: no allocator OOM taken by the "
                             "fallback, or its labels differ")
    return out


def _warmup_phase(build_s: float) -> dict:
    """Phase 22 (c): the warm-up command in a process of its own (the
    build directory is phase 2's, so its builds are found): rc 0 and each
    step's seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.time()
    proc = subprocess.run([sys.executable, *WARMUP_ARGV], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    seconds = time.time() - t0
    steps = [ln[2:] for ln in proc.stderr.splitlines()
             if ln.startswith("# ")]
    print(f"phase 22c python {' '.join(WARMUP_ARGV)}: rc "
          f"{proc.returncode}, {seconds:.1f} s; steps {steps}; phase 2's "
          f"build in this process {build_s:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"phase 22c: warm-up failed\n{proc.stderr}")
    return {"rc": proc.returncode, "seconds": seconds, "steps": steps,
            "phase2_build_s": build_s}


def _stencil_phase(torch, dev, sub_xzy) -> dict:
    """Phase 22 (d): B6 (bf16, f32) on an (X, Z, Y) sub-volume of the 3D
    fixture against _lp_cv_combine(line_profile_3d(edge-padded volume)),
    and B2 on a STENCIL_2D^2 image against the quartile combine of
    line_profile_2d's normalised centres, both stencil forms on the card;
    each within its kernel's tolerance."""
    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.ops import line_profile as lp

    def pad(t, p):
        return torch.nn.functional.pad(t[None, None], (p,) * (2 * t.ndim),
                                       mode="replicate")[0, 0]

    out = {}
    vol_xyz = sub_xzy.permute(0, 2, 1)
    for bf16 in (True, False):
        got = kernels.lpcv3d(sub_xzy, bf16)
        padded = pad(vol_xyz, 5)
        ref = lp._lp_cv_combine(lp.line_profile_3d(
            padded.to(torch.bfloat16) if bf16 else padded))
        out[f"lpcv3d {'bf16' if bf16 else 'f32'}"] = float(
            (got - ref.permute(0, 2, 1)).abs().max())
    img = torch.from_numpy(_smooth_image((STENCIL_2D,) * 2, 22)).to(dev)
    prof = lp.line_profile_2d(pad(img, 5))
    lo, hi = prof.min(dim=-1).values, prof.max(dim=-1).values
    rnc = (prof[..., 5] - lo) / torch.clamp(hi - lo, min=1e-8)
    out["lpcv2d"] = float((kernels.lpcv2d(img, 11, 9)
                           - lp._lp_cv_combine(rnc)).abs().max())
    ok = all(v <= TOL[k.split()[0]] for k, v in out.items())
    print(f"phase 22d stencil forms on the card, max_abs_err: "
          + ", ".join(f"{k} {v:.3e}" for k, v in out.items())
          + f" (B6 on {tuple(sub_xzy.shape)} (X, Z, Y), B2 on "
          f"{STENCIL_2D}^2; tol {TOL['lpcv3d']:.0e} abs) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 22d: a kernel disagrees with the "
                             "stencil form")
    return out


# phase 23: touching cells at production density, the scenes of
# tools/make_parity.py::fov_scene (copied: the script imports no tool):
# DENSE_CELLS cells (a 21 x 21 grid's worth) cycling through its codes on
# a DENSE_SIZE^2 FOV, placed by make_fov's dense mode, the 7-bit family at
# a 27 px pitch with cell axes (7, 12), the 10-bit one at 31 px with
# (9, 14), each with its nominal per-laser shifts. Three scenes per
# family: nominal (seed 100, noise 0.01), high_noise (seed 103, noise
# 0.05) and misregistered (seed 104: the 10-bit family at NEAR_CLAMP, the
# 7-bit one at MISREG_MODERATE plus a smooth sigma-8 illumination mottle
# of amplitude DENSE_PEDESTAL from RandomState(77)). Bars: accuracy >= 0.99
# over the matched cells, matched >= the scene's fraction of the planted
# cells. (a)'s 256^2 FOVs are tests/test_torch_dense_fov.py's
DENSE_CELLS = 441
DENSE_SIZE = 2000
DENSE_CODES_7B = (1, 9, 65, 127, 34, 88, 5, 96, 18, 73, 22, 41, 100, 55, 3,
                  77)
DENSE_CODES_10B = (5, 37, 515, 1023, 96, 640, 17, 260, 770, 129, 33, 514, 68,
                   272, 9, 48)
DENSE_FAMILIES = {
    "7b": dict(spacing=27.0, cell_axes=(7.0, 12.0),
               shifts=((0, 0), (1, 2), (-1, 0), (2, -2)),
               misreg=((0, 0), (6, -5), (-5, 4), (4, 6), (-5, -6)),
               pedestal=0.04, small=dict(n=36, seed=132, max_cells=64)),
    "10b": dict(spacing=31.0, cell_axes=(9.0, 14.0),
                shifts=((0, 0), (2, -1), (0, 3), (-2, 0), (1, 1)),
                misreg=((0, 0), (11, -9), (-12, 7), (8, 12), (-10, -11)),
                pedestal=0.0, small=dict(n=25, seed=126, max_cells=256)),
}
DENSE_SCENES = {"nominal": (100, 0.01, 0.95), "high_noise": (103, 0.05, 0.90),
                "misregistered": (104, 0.01, 0.90)}
DENSE_TIMED_CALLS = 3
# the remap stage's peak of phase 8 (GiB above what was live before the
# pass) when B4 stored f32 and the labels were cast to int32 after it
# (PERF.md §7)
REMAP_PEAK_F32_GIB = 2.63


def _dense_scene(family: str, scene: str, size: int = DENSE_SIZE,
                 n: int = DENSE_CELLS, seed: int | None = None):
    """One touching-cell FOV of phase 23 as tools/make_parity.py::fov_scene
    builds it (at ``size``^2 with ``n`` cells, and ``seed`` in place of
    the scene's): the make_fov dict with its codes."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
    from hiprfish_tpu_torch.utils import synthetic

    f = DENSE_FAMILIES[family]
    layout, base = ((SEVEN_BIT, DENSE_CODES_7B) if family == "7b"
                    else (TEN_BIT, DENSE_CODES_10B))
    codes = [base[i % len(base)] for i in range(n)]
    scene_seed, noise, _ = DENSE_SCENES[scene]
    shifts = f["misreg"][:len(f["shifts"])] if scene == "misregistered" \
        else f["shifts"]
    fov = synthetic.make_fov(
        layout, codes, shape=(size, size),
        seed=scene_seed if seed is None else seed, laser_shifts=shifts,
        cell_axes=f["cell_axes"], noise=noise, spacing=f["spacing"])
    if scene == "misregistered" and f["pedestal"]:
        from scipy.ndimage import gaussian_filter

        rng = np.random.RandomState(77)
        out = []
        for p in fov["stack"]:
            m = gaussian_filter(rng.randn(p.shape[0], p.shape[1])
                                .astype(np.float32), 8.0)
            m = 1.0 + m / max(float(np.abs(m).max()), 1e-9)
            out.append(p + f["pedestal"] * m[:, :, None])
        fov["stack"] = out
    fov["codes"] = codes
    fov["layout"] = layout
    return fov


def _dense_step(torch, family: str, stack, arrays, static, max_cells: int):
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.pipeline import fused, fused_ecoli

    step = fused.fov_step if family == "7b" else fused_ecoli.fov_step_ecoli
    return step(stack, arrays, SegmentationConfig(), max_cells, static)


def _dense_cpu_vs_card(torch, dev, clfs: dict) -> dict:
    """Phase 23 (a): a 256^2 touching-cell FOV of each family through its
    step on the CPU (plain versions) and on the card (kernels), held as
    phases 4 and 10 hold theirs: equal n_cells and calls on the valid
    rows, segmentation agreement >= 0.999."""
    from hiprfish_tpu_torch.pipeline import fused

    out = {}
    for family, f in DENSE_FAMILIES.items():
        sm = f["small"]
        fov = _dense_scene(family, "nominal", 256, sm["n"], sm["seed"])
        res = []
        for d in (torch.device("cpu"), dev):
            arr, st = fused.classifier_from_numpy(clfs[family], d)
            stack = tuple(torch.from_numpy(a).to(d) for a in fov["stack"])
            res.append(_dense_step(torch, family, stack, arr, st,
                                   sm["max_cells"]))
        cpu_r, gpu_r = res
        n_c, n_g = int(cpu_r.n_cells), int(gpu_r.n_cells)
        agree = float((cpu_r.segmentation
                       == gpu_r.segmentation.cpu()).float().mean())
        v = cpu_r.valid
        codes_eq = bool(torch.equal(cpu_r.code_idx[v],
                                    gpu_r.code_idx.cpu()[v]))
        print(f"phase 23a {family} 256^2 touching cells ({sm['n']} planted, "
              f"seed {sm['seed']}) cpu vs gpu: n_cells {n_c} / {n_g}, "
              f"segmentation agreement {agree:.6f}, code_idx equal "
              f"{codes_eq}")
        if n_c != n_g or not codes_eq or agree < 0.999:
            raise AssertionError(f"phase 23a {family}: the card disagrees "
                                 "with the CPU")
        out[family] = {"n_cells": [n_c, n_g], "agreement": agree,
                       "code_idx_equal": codes_eq}
    return out


def _dense_phase(torch, kernels, dev, clfs: dict) -> dict:
    """Phase 23: touching cells at production density. (a) the CPU against
    the card at 256^2; (b) the 7-bit scenes through fused.fov_step with
    the 127-code classifier, (c) the 10-bit scenes through
    fused_ecoli.fov_step_ecoli with the 1023-class classifier, both at
    max_cells MAX_CELLS. Per scene: launches counted from zero in the
    first call (B1-B4 on the 7-bit step, B3 and B4 on the 10-bit one),
    n_cells, matched and accuracy by _barcode_accuracy, ms/FOV as the
    median of DENSE_TIMED_CALLS synchronised calls after the first, the
    peak device memory over the calls above what was live before them,
    and n_cells and labels equal in every call. Writes nothing to disk."""
    from hiprfish_tpu_torch.pipeline import fused

    t_phase = time.time()
    out = {"cpu vs card": _dense_cpu_vs_card(torch, dev, clfs)}
    for family, path, tag in (("7b", PATH_2D, "b"), ("10b", PATH_ECOLI, "c")):
        arrays, static = fused.classifier_from_numpy(clfs[family], dev)
        codebook = list(clfs[family].codebook)
        for scene, (_, _, frac) in DENSE_SCENES.items():
            t0 = time.time()
            fov = _dense_scene(family, scene)
            build_s = time.time() - t0
            truth, codes, layout = fov["truth_labels"], fov["codes"], \
                fov["layout"]
            stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
            del fov
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launches()
            t0 = time.time()
            res = _dense_step(torch, family, stack, arrays, static,
                              MAX_CELLS)
            torch.cuda.synchronize()
            first_s = time.time() - t0
            launches = kernels.launch_counts()
            seg0 = res.segmentation
            n_found = int(res.n_cells)
            if tuple(seg0.shape) != (DENSE_SIZE, DENSE_SIZE) \
                    or not bool(torch.isfinite(res.avgint).all()):
                raise AssertionError(f"phase 23{tag} {scene}: output "
                                     "malformed")
            correct, matched = _barcode_accuracy(
                seg0.cpu().numpy(), truth, res.code_idx.cpu().numpy(), codes,
                codebook, layout, n_found, MAX_CELLS)
            acc = correct / max(matched, 1)
            times, n_calls, same_labels = [], [n_found], True
            for _ in range(DENSE_TIMED_CALLS):
                t0 = time.time()
                r = _dense_step(torch, family, stack, arrays, static,
                                MAX_CELLS)
                torch.cuda.synchronize()
                times.append((time.time() - t0) * 1000)
                n_calls.append(int(r.n_cells))
                same_labels &= bool(torch.equal(r.segmentation, seg0))
            peak_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
            ms = float(np.median(times))
            missing = [k for k in path if launches[k] == 0]
            print(f"phase 23{tag} {family} {scene} {DENSE_SIZE}^2 "
                  f"({DENSE_CELLS} touching cells, built in {build_s:.1f} "
                  f"s): n_cells {n_found}, matched {matched}, accuracy "
                  f"{acc:.4f} ({correct}/{matched}), first call "
                  f"{first_s:.2f} s, {ms:.1f} ms/FOV (median of "
                  f"{DENSE_TIMED_CALLS}; all {[round(t, 1) for t in times]})"
                  f", peak {peak_gib:.2f} GiB above {base / 2 ** 30:.2f} "
                  f"GiB live; n_cells of the calls {n_calls}, labels equal "
                  f"{same_labels}; launches {launches}")
            out[f"{family} {scene}"] = {
                "n_cells": n_found, "matched": matched, "correct": correct,
                "accuracy": acc, "planted": DENSE_CELLS, "ms": ms,
                "times_ms": times, "first_s": first_s,
                "peak_gib": peak_gib, "base_gib": base / 2 ** 30,
                "n_calls": n_calls, "labels_equal": same_labels,
                "launches": launches}
            if missing:
                raise AssertionError(f"phase 23{tag} {scene}: kernels not "
                                     f"launched: {missing}")
            if acc < 0.99 or matched < frac * DENSE_CELLS:
                raise AssertionError(
                    f"phase 23{tag} {family} {scene}: accuracy {acc:.4f} "
                    f"below 0.99 or {matched} matched below "
                    f"{frac} x {DENSE_CELLS}")
            if len(set(n_calls)) != 1 or not same_labels:
                raise AssertionError(f"phase 23{tag} {family} {scene}: "
                                     "n_cells or labels differ between "
                                     "calls")
            del stack, res, r, seg0
    out["seconds"] = time.time() - t_phase
    print(f"phase 23: {out['seconds']:.1f} s")
    return out


# phase 24: the fixpoint floods from CUDA graphs (ops/labeling._fixpoint)
# against the same floods one round at a time, timed per flood (median of
# FLOOD_TIMED_CALLS synchronised calls), and whole steps with and without
# the graphs on two 2000^2 FOVs of each kind
FLOOD_TIMED_CALLS = 5


def _no_graphs():
    """Within the block the flood driver runs every loop one round at a
    time, as it does for CPU and 3D tensors."""
    from hiprfish_tpu_torch.ops import labeling as lab

    return mock.patch.object(lab, "_takes_graphs", lambda t: False)


def _flood_rounds(torch, fn) -> tuple:
    """(fn's output, the rounds and replays of each flood span in it), the
    spans recorded under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from hiprfish_tpu_torch.utils.logging import RECORDER

    RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    spans = [(r["attrs"]["rounds"], r["attrs"]["replays"])
             for r in RECORDER.snapshot() if r["name"].startswith("flood.")]
    RECORDER.reset()
    return out, spans


def _synced_ms(torch, fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _flood_graph_phase(torch, dev, clfs: dict) -> dict:
    """Phase 24: (a) each flood of the 7-bit and the 10-bit step, recorded
    at its call in one step on the nominal 2000^2 touching-cell scene of
    phase 23, run from graphs and one round at a time: equal outputs
    (bitwise) and rounds, the graphs' replays, and both times; (b) whole
    steps (fov_step, fov_step_ecoli) with and without the graphs on two
    FOVs each of 7-bit touching cells (phase 23's nominal and high_noise
    scenes), 10-bit touching cells (the same) and 7-bit sparse cells (the
    flagship FOV and its layout at seed 2): labels, n_cells, calls and
    valid bitwise; (c) the driver's captures and replays counted."""
    from hiprfish_tpu_torch.config import SEVEN_BIT
    from hiprfish_tpu_torch.ops import labeling as lab
    from hiprfish_tpu_torch.ops import watershed as ws
    from hiprfish_tpu_torch.pipeline import fused
    from hiprfish_tpu_torch.utils import synthetic

    t_phase = time.time()
    replays0 = lab.replays
    out = {"floods": {}, "steps": {}}
    arrays = {f: fused.classifier_from_numpy(c, dev) for f, c in clfs.items()}

    def step(family, stack):
        return _dense_step(torch, family, stack, *arrays[family], MAX_CELLS)

    for family in ("7b", "10b"):
        fov = _dense_scene(family, "nominal")
        stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
        del fov
        calls = []
        orig = lab._fixpoint

        def record(name, key, body, state, consts, max_iters):
            calls.append((name, key, body, tuple(t.clone() for t in state),
                          tuple(t.clone() for t in consts), max_iters))
            return orig(name, key, body, state, consts, max_iters)

        lab._fixpoint = ws._fixpoint = record
        try:
            step(family, stack)
        finally:
            lab._fixpoint = ws._fixpoint = orig
        rows = []
        for i, (name, key, body, state, consts, iters) in enumerate(calls):
            def run():
                return lab._fixpoint(name, key, body, state, consts, iters)

            run()
            got, spans_g = _flood_rounds(torch, run)
            graph_ms = _synced_ms(torch, run, FLOOD_TIMED_CALLS)
            with _no_graphs():
                want, spans_l = _flood_rounds(torch, run)
                loop_ms = _synced_ms(torch, run, FLOOD_TIMED_CALLS)
            same = all(a.dtype == b.dtype and bool(torch.equal(a, b))
                       for a, b in zip(got, want))
            (rounds_g, replays_g), = spans_g
            (rounds_l, _), = spans_l
            row = {"flood": name, "key": str(key),
                   "shape": list(state[0].shape), "rounds": rounds_l,
                   "rounds_graphs": rounds_g, "replays": replays_g,
                   "loop_ms": loop_ms, "graphs_ms": graph_ms,
                   "equal": same}
            rows.append(row)
            print(f"phase 24a {family} flood {i} {name} {key}: rounds "
                  f"{rounds_l} / {rounds_g} from {replays_g} replays, "
                  f"one round at a time {loop_ms:.2f} ms, from graphs "
                  f"{graph_ms:.2f} ms, outputs equal {same}")
            if not same or rounds_g != rounds_l or replays_g < 1:
                raise AssertionError(f"phase 24a {family} {name}: the "
                                     "graphs disagree with the loop")
        out["floods"][family] = rows
        del stack, calls

    def sparse_fov(seed):
        return synthetic.make_fov(
            SEVEN_BIT, synthetic.FLAGSHIP_CODES,
            shape=synthetic.FLAGSHIP_SHAPE, seed=seed,
            laser_shifts=synthetic.FLAGSHIP_SHIFTS,
            cell_axes=synthetic.FLAGSHIP_CELL_AXES)

    for kind, family, make in (
            ("7b touching", "7b", lambda s: _dense_scene("7b", s)),
            ("10b touching", "10b", lambda s: _dense_scene("10b", s)),
            ("7b sparse", "7b", lambda s: sparse_fov(
                1 if s == "nominal" else 2))):
        for scene in ("nominal", "high_noise"):
            fov = make(scene)
            stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
            del fov
            res_g = step(family, stack)
            with _no_graphs():
                res_l = step(family, stack)
            equal = {f: bool(torch.equal(getattr(res_g, f),
                                         getattr(res_l, f)))
                     for f in ("segmentation", "n_cells", "code_idx",
                               "valid")}
            print(f"phase 24b {kind} {scene}: n_cells {int(res_g.n_cells)}"
                  f" / {int(res_l.n_cells)}, bitwise {equal}")
            out["steps"][f"{kind} {scene}"] = {
                "n_cells": int(res_g.n_cells), "equal": equal}
            if not all(equal.values()):
                raise AssertionError(f"phase 24b {kind} {scene}: the step "
                                     "differs with the graphs")
            del stack, res_g, res_l
    # the keys of these shapes may have been captured by earlier phases
    out["captures"] = lab.captures
    out["replays"] = lab.replays - replays0
    out["seconds"] = time.time() - t_phase
    print(f"phase 24: captures {out['captures']} in the process, replays "
          f"{out['replays']} in the phase, {out['seconds']:.1f} s")
    if out["captures"] < 1 or out["replays"] < 1:
        raise AssertionError("phase 24: the floods replayed no graph")
    return out


# phase 25: the flood rounds of csrc/flood.cu against their plain twins,
# as (kind, shape, connectivity, max_run, mask density): a 3D tile's CCL
# and rank ((360 + 2 x 64) x 170 x 2020, tile_cap's scan cap 32), the 3D
# pass's seed fill-holes over the 2020 x 170 x 2020 volume (max_run 128),
# and the 2D steps' floods at 2000^2 (scan_cap 16, the 10-bit small
# holes' 64)
FLOOD_ROUNDS = (
    ("min", (488, 170, 2020), 3, 32, 0.45),
    ("reach", (2020, 170, 2020), 1, 128, 0.6),
    ("min", (2000, 2000), 2, 16, 0.5),
    ("min", (2000, 2000), 1, 64, 0.5),
    ("reach", (2000, 2000), 1, 64, 0.6),
    ("reach", (2000, 2000), 2, 16, 0.6),
)


def _flood_kernel_phase(torch, dev) -> dict:
    """Phase 25: one round of each FLOOD_ROUNDS case on csrc/flood.cu
    (kernels.flood_min / flood_reach) and on its plain twin
    (labeling._min_round_plain / _reach_round_plain) from the same random
    mask and state (the min state with values off the mask, as round 1 of
    rank has them): bitwise equal outputs; the kernel round's time alone
    and with the fixpoint's change test, the plain round's, and the
    round's bound: its passes' bytes (each reads the state and the mask
    once and writes the state once; kernels.flood_plan) over the card's
    rate, and with the change test's two state reads."""
    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.ops import labeling as lab

    t_phase = time.time()
    out = {"rounds": []}
    for kind, shape, conn, cap, density in FLOOD_ROUNDS:
        gen = torch.Generator(device=dev).manual_seed(25)
        mask = torch.rand(shape, generator=gen, device=dev) < density
        full = kind == "min" and conn == len(shape)
        if kind == "min":
            cur = torch.randint(1, 1 << 30, shape, generator=gen, device=dev,
                                dtype=torch.int32)
            consts = (mask, torch.full_like(cur, lab._INF))
            plain = lab._min_round_plain(len(shape), conn, cap)
            binding = kernels.flood_min
        else:
            cur = torch.rand(shape, generator=gen, device=dev) < 0.01
            consts = (mask,)
            plain = lab._reach_round_plain(len(shape), conn, cap)
            binding = kernels.flood_reach

        def kernel():
            return binding(cur, mask, conn, cap)

        def with_test():
            return lab._changed((kernel(),), (cur,))

        got, (want,) = kernel(), plain((cur,), consts)
        torch.cuda.synchronize()
        equal = got.dtype == want.dtype and bool(torch.equal(got, want))
        del got, want
        ms = _time_ms(torch, kernel, 20)
        test_ms = _time_ms(torch, with_test, 20)
        plain_ms = _time_ms(torch, lambda: plain((cur,), consts), 3)
        elem = cur.element_size()
        passes = len(kernels.flood_plan(shape, conn, cap, full, elem))
        nbytes = passes * cur.numel() * (2 * elem + 1)
        bound_ms, by = bound(0, nbytes)
        test_bound_ms, _ = bound(0, nbytes + 2 * elem * cur.numel())
        row = {"kernel": binding.__name__, "shape": list(shape),
               "connectivity": conn, "max_run": cap, "passes": passes,
               "equal": equal, "ms": ms, "with_change_test_ms": test_ms,
               "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": bound_ms,
               "bound_by": by, "share": bound_ms / ms,
               "with_change_test_bound_ms": test_bound_ms,
               "with_change_test_share": test_bound_ms / test_ms}
        out["rounds"].append(row)
        print(f"phase 25 {binding.__name__} {tuple(shape)} conn {conn} "
              f"max_run {cap}: bitwise {equal}, kernel {ms:.3f} ms (with "
              f"the change test {test_ms:.3f}) plain {plain_ms:.3f} ms, "
              f"{passes} passes, bound {bound_ms:.4g} ms ({by}) share "
              f"{bound_ms / ms:.3f} (with the test {test_bound_ms:.4g} ms, "
              f"{test_bound_ms / test_ms:.3f}) {'ok' if equal else 'FAIL'}")
        if not equal:
            raise AssertionError(f"phase 25 {binding.__name__} {shape}: the "
                                 "kernel round differs from the plain one")
        del cur, mask, consts
        torch.cuda.empty_cache()
    out["launches"] = {k: v for k, v in kernels.launch_counts().items()
                       if k.startswith("flood_")}
    out["seconds"] = time.time() - t_phase
    print(f"phase 25: {out['seconds']:.1f} s, launches {out['launches']}")
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
    build_s = time.time() - t0
    print(f"phase 2 build: {build_s:.1f} s -> {lib}, "
          f"{[str(p) for p in libs3]}")
    for stem in ("nlm", "lpcv2d", "segstats", "lpcv3d", "flood"):
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
    # the int32 store, on a remap table as the steps build it (ids as f32,
    # dropped cells 0); the yardstick: one gather from the int32 table
    itbl, itbl0 = _remap_tables(torch, gen, nseg, dev)
    check("label_lookup[2000^2 int32]",
          lambda: kernels.label_lookup(labels, itbl, torch.int32),
          lambda: segstats.label_lookup_plain(labels, itbl, torch.int32), 20,
          20, kernel_work("label_lookup", pixels=labels.numel(),
                          segments=nseg),
          lambda: torch.index_select(itbl0, 0, flat))
    del itbl, itbl0

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
    # phase 21's reference: this FOV's labels and calls
    refs = {"ref5_seg": seg, "ref5_n": np.int64(n_found),
            "ref5_codes": res.code_idx[1:n_found + 1].cpu().numpy()}
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
    # 22(d)'s (X, Z, Y) sub-volume of the normalised fixture
    stencil_sub = (vol[:STENCIL_3D[0], :STENCIL_3D[2], :] / vol.max()) \
        .permute(0, 2, 1).contiguous()
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
    # the int32 store of segment_3d_tiled's remap and seed filter
    ttbl, ttbl0 = _remap_tables(torch, gen, tcap, dev)
    check("label_lookup[tile3d int32]",
          lambda: kernels.label_lookup(tile, ttbl, torch.int32),
          lambda: segstats.label_lookup_plain(tile, ttbl, torch.int32), 10, 3,
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
                      MAX_CELLS_3D, keep_labels=True)
    launches3 = r3["launches"]
    print(f"phase 8 stages (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in r3["stages"].items())
        + f"; total {r3['total']:.2f} s; peak memory {r3['peak_gib']:.2f} "
        f"GiB; launches {launches3}")
    print(f"phase 8 stage peaks (GiB): {r3['stage_peaks_text']}")
    remap_gib = r3["stage_peaks_gib"]["remap"] - r3["base_gib"]
    labels_sha = hashlib.sha256(np.ascontiguousarray(
        r3["seg_xzy"].numpy()).data).hexdigest()
    print(f"phase 8 remap stage peak {remap_gib:.2f} GiB above the pass's "
          f"base ({REMAP_PEAK_F32_GIB:.2f} GiB with B4's f32 store and a "
          f"cast after it); labels {tuple(r3['seg_xzy'].shape)} int32 sha256 "
          f"{labels_sha}")
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

    # phase 22 (a)'s reference: the global seeds' labels and result
    ref8 = {"seg_xzy": r3.pop("seg_xzy"), "n_cells": r3["n_cells"],
            "correct": r3["correct"], "matched": r3["matched"],
            "total": r3["total"], "stage_peaks_text": r3["stage_peaks_text"]}
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
    refs.update(ref11_seg=eseg, ref11_n=np.int64(en_found),
                ref11_codes=eres.code_idx[1:en_found + 1].cpu().numpy())
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

    # 19. the Zeiss readers and the batch runner
    torch.cuda.empty_cache()
    readers = _reader_phase(torch, kernels, FIXTURE_10B, FIXTURE,
                            planes.name, launches, dev)

    # 20. the reference's legacy UMAP stacks
    torch.cuda.empty_cache()
    legacy = _legacy_phase(torch, kernels, planes.name, dev)

    # 21. the scale-out over torch.distributed
    torch.cuda.empty_cache()
    scale = _scaleout_phase(torch, kernels, planes.name, refs, dev)
    planes.cleanup()
    w1, w2 = scale["world 1"], scale["world 2"]

    # 22. in-tile seeds and their OOM fallback, the warm-up command, the
    # stencil forms
    torch.cuda.empty_cache()
    t22 = time.time()
    intile = _in_tile_phase(torch, dev, clf, ref8)
    del ref8
    fallback = _fallback_phase()
    warm = _warmup_phase(build_s)
    stencils = _stencil_phase(torch, dev, stencil_sub)
    del stencil_sub
    print(f"phase 22: {time.time() - t22:.1f} s")

    # 23. touching cells at production density
    torch.cuda.empty_cache()
    dense = _dense_phase(torch, kernels, dev, {"7b": clf, "10b": clf10})

    # 24. the fixpoint floods from CUDA graphs
    floods = _flood_graph_phase(torch, dev, {"7b": clf, "10b": clf10})

    # 25. the flood rounds' kernels against their plain twins
    torch.cuda.empty_cache()
    flood_rounds = _flood_kernel_phase(torch, dev)

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
                   wf["multispecies"]["launches"], PATH_CLI_MULTISPECIES),
               "cli.measure_multispecies, czi": (
                   readers["a"]["launches"], PATH_CLI_MULTISPECIES),
               "cli.measure, czi": (readers["b"]["launches"],
                                    PATH_CLI_MEASURE),
               "run_batch_pipeline": (readers["c"]["launches"], PATH_2D),
               "cli.biofilm -d 3, czi": (readers["d"]["launches"],
                                         PATH_BIOFILM_3D),
               "cli.classify, legacy stack": (
                   legacy["10b"]["cold"]["launches"], ()),
               "cli.classify_spectra, legacy stack": (
                   legacy["7b"]["cold"]["launches"], ())}
    for tag, w in (("world 1", w1), ("world 2", w2)):
        by_path.update({
            f"batched_fov_step, {tag}": (w["batched_fov_step"]["launches"],
                                         PATH_2D),
            f"batched_fov_step_ecoli, {tag}": (
                w["batched_fov_step_ecoli"]["launches"], PATH_ECOLI),
            f"lp_cv_enhance_2d_sharded, {tag}": (
                w["lp_cv_enhance_2d_sharded"]["launches"], ("lpcv2d",)),
            f"segment_3d_tiled mesh, {tag}": (
                w["segment_3d_tiled mesh"]["launches"],
                ("label_stats", "label_lookup", "lpcv3d")),
            f"measure_volume_zsharded, {tag}": (
                w["measure_volume_zsharded"]["launches"], ("stats_cm",))})
    by_path["run_distributed_pipeline, world 2"] = (
        w2["run_distributed_pipeline"]["launches"], PATH_2D)
    by_path["run_batch_pipeline, OOM halving"] = (
        scale["oom"]["capped"]["launches"], PATH_2D)
    by_path["volume_3d, in-tile seeds"] = (intile["launches"], PATH_3D)
    by_path["segment_3d_tiled, OOM fallback"] = (
        fallback["launches_fallback"],
        ("label_stats", "label_lookup", "lpcv3d"))
    for family, path in (("7b", PATH_2D), ("10b", PATH_ECOLI)):
        step = "fov_step" if family == "7b" else "fov_step_ecoli"
        for scene in DENSE_SCENES:
            by_path[f"{step}, dense {scene}"] = (
                dense[f"{family} {scene}"]["launches"], path)
    entries = []
    for key in REPORT_ORDER:
        k = key.split("[")[0]
        # an int32 entry counts B4's int32 stores only
        ck = "label_lookup_i32" if key.endswith(" int32]") else k
        entries.append({
            "name": key, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": sum(c.get(ck, 0) * (k in p)
                            for c, p in by_path.values()),
            "launches_by_path": {name: c.get(ck, 0) * (k in p)
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
                      "workflow": wf, "readers": readers,
                      "legacy": legacy, "scale_out": scale,
                      "in_tile_seeds": {"volume": intile,
                                        "oom_fallback": fallback,
                                        "warmup": warm,
                                        "stencil_forms": stencils},
                      "dense": dense, "flood_graphs": floods,
                      "flood_rounds": flood_rounds,
                      "volume_3d": {"remap_peak_gib": remap_gib,
                                    "labels_sha256": labels_sha}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
