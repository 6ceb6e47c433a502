"""The 7-bit flagship FOV step in PyTorch (port of
hiprfish_tpu/pipeline/fused.py).

``fov_step`` takes a multi-laser FOV from raw per-laser planes to per-cell
barcode calls: FFT registration -> NL-means (kernel B1) -> LP-CV (kernel
B2) -> KMeans -> opening + fill-holes -> CCL + rank -> seed size filter
(kernels B3, B4) -> watershed -> per-cell stats (B3) -> size/border filter
and relabel (B4) -> mean spectra -> check heads -> gated block-cosine kNN
vote. It runs eagerly on the device of its inputs. Where the reference
branched inside the compiled program (``lax.cond``, ``while_loop`` exit
tests), the port reads a scalar back to the host and branches in Python.

Each call is the span ``step`` over the stage spans ``register``,
``denoise``, ``lpcv``, ``kmeans``, ``morphology``, ``markers``,
``watershed``, ``stats`` and ``classify`` (``utils.logging.span``: on
while a torch profiler records). The kernel entries are called through
their modules (``dn.denoise_nl_means``, ``lp.lp_cv_enhance_2d``,
``segstats.label_stats``, ``segstats.label_lookup``), so that a wrapper
set on the module sees every call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.models import metrics
from hiprfish_tpu_torch.models.classifier import CheckHead
from hiprfish_tpu_torch.ops import denoise as dn
from hiprfish_tpu_torch.ops import kmeans as km
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.ops import line_profile as lp
from hiprfish_tpu_torch.ops import morphology as morph
from hiprfish_tpu_torch.ops import register as reg
from hiprfish_tpu_torch.ops import segstats
from hiprfish_tpu_torch.ops import watershed as ws
from hiprfish_tpu_torch.utils.logging import host_wait, span


class FovResult(NamedTuple):
    segmentation: torch.Tensor   # (H, W) int32 sequential labels
    n_cells: torch.Tensor        # scalar int32
    avgint: torch.Tensor         # (max_cells, C) mean spectra (row 0 unused)
    avgint_norm: torch.Tensor    # row-max normalized
    code_idx: torch.Tensor       # (max_cells,) predicted class index
    max_prob: torch.Tensor       # (max_cells,) kNN vote fraction
    valid: torch.Tensor          # (max_cells,) bool cell-slot validity


def segment_lpcv_device(stack, calibration, cfg: SegmentationConfig,
                        max_cells: int, denoise: bool = True):
    """LP-CV segmentation of one FOV; ``stack`` is a tuple of per-laser
    (H, W, C_l) tensors. Returns (labels (H, W) int32, registered cube
    (H, W, C) in cfg.registered_dtype, or f32 when calibrated)."""
    with span("register"):
        projections = [torch.sum(img, dim=2) for img in stack]
        ref0 = projections[0]
        c = cfg.register_crop
        h, w = ref0.shape
        if c and h > c and w > c:
            r0, c0 = (h - c) // 2, (w - c) // 2
            _crop = lambda im: im[r0:r0 + c, c0:c0 + c]  # noqa: E731
        else:
            _crop = lambda im: im  # noqa: E731
        cref = _crop(ref0)
        # The cube feeds only the per-cell spectral sums, so it is stored
        # in cfg.registered_dtype (bf16 by default); the NLM/KMeans input
        # is built from the f32 per-laser sums rolled by the same shifts.
        reg_dt = getattr(torch, cfg.registered_dtype) \
            if calibration is None else torch.float32
        parts = [stack[0].to(reg_dt)]
        fov_sum = projections[0]
        for i in range(1, len(stack)):
            s = reg.register_translation(cref, _crop(projections[i]))
            if cfg.clamp_shift:
                s = reg.clamp_shift(s, cfg.max_shift)
            shifted, _ = reg.apply_shift_2d(stack[i].to(reg_dt), s)
            parts.append(shifted)
            fov_sum = fov_sum + reg.apply_shift_2d(projections[i], s)[0]
        registered = torch.cat(parts, dim=2)
        if calibration is not None:
            registered = registered / calibration
            fov_sum = torch.sum(registered, dim=2)
        sum_norm = fov_sum / torch.clamp(torch.max(fov_sum), min=1e-12)
    if denoise:
        with span("denoise"):
            den = dn.denoise_nl_means(sum_norm, cfg.nlm_h,
                                      cfg.nlm_patch_size,
                                      cfg.nlm_patch_distance)
    else:
        den = sum_norm
    with span("lpcv"):
        enhanced = lp.lp_cv_enhance_2d(den, cfg.patch_size, cfg.phi_range)

    with span("kmeans"):
        bkg = km.brightest_cluster_mask(den, 2, cfg.kmeans_iters)
        fg = km.brightest_cluster_mask(enhanced, 2, cfg.kmeans_iters) & bkg
    with span("morphology"):
        # fill(opening(fg)) covers fill(fg) & opening: one border flood
        seed_mask = morph.binary_fill_holes(morph.binary_opening(fg), 1, 64)

    with span("markers"):
        # rank the markers to sequential ids before flooding; small seeds
        # are dropped after this single CCL by a per-label count pass
        markers0 = lab.label(seed_mask, 2, cfg.ccl_max_iters, cfg.scan_cap)
        markers_seq, _ = segstats.rank_labels(markers0, 2,
                                              cfg.ccl_max_iters,
                                              cfg.scan_cap)
        pre_segments = 2 * max_cells
        markers_seq = torch.clamp(markers_seq, max=pre_segments - 1)
        st = segstats.label_stats(markers_seq, None, pre_segments)
        ids = torch.arange(pre_segments, dtype=torch.float32,
                           device=markers_seq.device)
        keep_tbl = torch.where(st.counts >= cfg.lp_seed_min_size, ids,
                               torch.zeros_like(ids))
        keep_tbl[0] = 0.0
        markers = segstats.label_lookup(markers_seq, keep_tbl,
                                        out_dtype=torch.int32) \
            * bkg.to(torch.int32)
    with span("watershed"):
        seg = ws.watershed(-(enhanced * bkg), markers, fg & bkg, 1,
                           cfg.watershed_max_iters)
    return seg, registered


def classify_device(avgint_norm, check_heads, check_blocks, scaler_mean,
                    scaler_scale, train_features, train_labels, n_classes,
                    blocks, check_slice, n_channels, k, temperature,
                    full: bool = False):
    """Feature build + check heads + gated-metric kNN vote for a
    (rows, C) block of normalized spectra (with any derivative columns
    appended). Returns (code_idx, max_prob), and with ``full`` also the
    (rows, n_classes) vote scores and the feature rows [spectra, check
    bits]."""
    x = avgint_norm[:, :n_channels]
    scaled = x if scaler_mean is None else (x - scaler_mean) / scaler_scale
    wmax = check_heads[0].d_in
    checks = []
    for head, (lo, hi) in zip(check_heads, check_blocks):
        xin = scaled[:, lo:hi] if hi <= n_channels else avgint_norm[:, lo:hi]
        xin = F.pad(xin, (0, wmax - (hi - lo)))
        checks.append((head(xin) > 0).to(torch.float32))
    feats = torch.cat([avgint_norm, torch.stack(checks, dim=1)], dim=1)

    d = metrics.block_cosine_distance_matrix(feats, train_features, blocks,
                                             check_slice)
    # exact top-k with ties to the lower index, as lax.top_k (the
    # reference's approx_max_k is exact off the TPU); torch.topk leaves the
    # order of ties open, and all-zero padding rows tie everywhere
    neg_d, idx = torch.sort(-d, dim=1, descending=True, stable=True)
    neg_d, idx = neg_d[:, :k], idx[:, :k]
    nb = train_labels[idx].to(torch.int64)
    w = torch.softmax(neg_d * temperature, dim=1)
    scores = torch.zeros((feats.shape[0], n_classes), dtype=torch.float32,
                         device=feats.device)
    # one neighbour rank at a time: within a call every row adds to one
    # class, so no two additions race, and each class sums its
    # neighbours' weights nearest first on every device, as the
    # reference's in-order scatter
    for j in range(nb.shape[1]):
        scores.scatter_add_(1, nb[:, j:j + 1], w[:, j:j + 1])
    # argmax takes the first index on ties, as jnp.argmax
    code_idx = torch.argmax(scores, dim=1).to(torch.int32)
    max_prob = torch.max(scores, dim=1).values
    if full:
        return code_idx, max_prob, scores, feats
    return code_idx, max_prob


def classify_capped(spectra_rows, n_cells, cap, *clf_args):
    """classify_device on only the first ``cap`` rows when fewer than
    ``cap`` cells exist (labels are sequential, so only those rows can hold
    cells), zero-padded back to all rows; the full rows otherwise. The
    branch reads ``n_cells`` back to the host."""
    n = spectra_rows.shape[0]
    if cap is None or cap >= n or host_wait(int, n_cells) >= cap:
        return classify_device(spectra_rows, *clf_args)
    ci, mp = classify_device(spectra_rows[:cap], *clf_args)
    out_ci = torch.zeros((n,), dtype=ci.dtype, device=ci.device)
    out_mp = torch.zeros((n,), dtype=mp.dtype, device=mp.device)
    out_ci[:cap] = ci
    out_mp[:cap] = mp
    return out_ci, out_mp


def _scatter_last(out: torch.Tensor, remap: torch.Tensor,
                  keep: torch.Tensor, rows: torch.Tensor) -> None:
    """out[remap[i]] = rows[i] for every kept id i, in place; row 0 stays
    zero. Ids capped at out.shape[0] - 1 collide there, and the last one
    wins, as in the reference's in-order scatter."""
    kept = host_wait(torch.nonzero, keep).squeeze(1)
    dest = remap[kept]
    last = torch.ones_like(dest, dtype=torch.bool)
    last[:-1] = dest[1:] != dest[:-1]
    out[dest[last].to(torch.int64)] = rows[kept[last]]
    out[0] = 0.0


def fov_step(stack, clf_arrays, cfg: SegmentationConfig, max_cells: int,
             clf_static, denoise: bool = True,
             classify_cap: int = 2048) -> FovResult:
    """The flagship forward step: raw per-laser planes -> barcode calls.

    stack: tuple of per-laser (H, W, C_l) float32 tensors on one device.
    clf_arrays, clf_static: from classifier_from_numpy.
    """
    # the kNN distances are float32 GEMMs: no TF32 anywhere in the step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = clf_static
    with span("step"):
        seg0, registered = segment_lpcv_device(
            stack, clf_arrays.get("calibration"), cfg, max_cells, denoise)
        with span("stats"):
            # one pass gives every region's pixel count, border contact
            # and spectral sum
            pre_segments = 2 * max_cells
            stats = segstats.label_stats(seg0, registered, pre_segments)
            keep = (stats.counts >= cfg.lp_cell_min_size) \
                & (stats.border_hits == 0)
            keep[0] = False
            final = torch.cumsum(keep.to(torch.int32), dim=0,
                                 dtype=torch.int32)
            n_cells = final[-1]
            remap = torch.where(keep, torch.clamp(final, max=max_cells - 1),
                                torch.zeros_like(final))
            seg = segstats.label_lookup(seg0, remap, out_dtype=torch.int32)
            means = stats.sums / torch.clamp(stats.counts, min=1.0)[:, None]
            avgint = torch.zeros((max_cells, means.shape[1]),
                                 dtype=torch.float32, device=means.device)
            _scatter_last(avgint, remap, keep, means)
        with span("classify"):
            avgint_norm = avgint / torch.clamp(
                torch.max(avgint, dim=1, keepdim=True).values, min=1e-12)
            code_idx, max_prob = classify_capped(
                avgint_norm, n_cells, classify_cap,
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
    return FovResult(seg, n_cells, avgint, avgint_norm, code_idx, max_prob,
                     valid)


def classifier_from_numpy(clf, device=torch.device("cuda")):
    """Split a classifier given as numpy arrays (models/artifacts.py's
    ClassifierArrays, or the reference's SpectralClassifier, whose fields
    are numpy) into (arrays dict of tensors and CheckHead modules, static
    tuple) for fov_step — the counterpart of the reference's
    classifier_to_device_args. The tensors go to the card unless the
    caller names another device.

    The check heads take their blocks zero-padded to one width, the widest
    block's (for the 10-bit violet-derivative classifier 6 heads over
    blocks of 32, 23, 20, 14, 6 and 31 columns, the last past
    ``n_channels``: the derivative features)."""
    widths = {np.asarray(p["w1"]).shape[0] for p in clf.check_params}
    if len(widths) != 1 or max(hi - lo for lo, hi in clf.check_blocks) \
            > min(widths):
        raise ValueError("classifier_from_numpy: check heads must share "
                         "one input width covering every check block")
    arrays = {
        "train_features": torch.as_tensor(
            np.asarray(clf.train_features, np.float32), device=device),
        "train_labels": torch.as_tensor(
            np.asarray(clf.train_labels, np.int64), device=device),
        "check_heads": torch.nn.ModuleList(
            [CheckHead.from_numpy(p, device) for p in clf.check_params]),
    }
    if clf.scaler_mean is not None:
        arrays["scaler_mean"] = torch.as_tensor(
            np.asarray(clf.scaler_mean, np.float32), device=device)
        arrays["scaler_scale"] = torch.as_tensor(
            np.asarray(clf.scaler_scale, np.float32), device=device)
    static = (
        len(clf.codebook),
        tuple(tuple(b) for b in clf.blocks),
        tuple(clf.check_slice),
        clf.n_channels,
        clf.n_neighbors,
        clf.temperature,
        tuple(tuple(b) for b in clf.check_blocks),
    )
    return arrays, static
