"""Per-label statistics, lookup, sequential ranking and small-hole removal
(torch port of hiprfish_tpu/ops/segstats.py).

``label_stats`` wraps kernel B3 and ``label_lookup`` kernel B4
(csrc/segstats.cu). The reference's banded one-hot matmuls, window spill
flags and exact fallbacks were the TPU's way around a slow scatter; here a
per-label reduction is a scatter-add (plain version) or an atomic kernel,
exact for any label image, so ``spill`` is always False. Every column
whose terms are integers (count, border, moments, aux histogram, a 0/1
mask's count) comes out exact and the same in every run, on either
device: the moments are int64 sums rounded once to f32. Semantics kept
from the reference's fast path: ids are clipped to [0, num_segments - 1],
label 0 never accumulates (row 0 stays zero), and a lookup gives 0.0 for
label <= 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.ops import morphology as morph
from hiprfish_tpu_torch.ops.labeling import _INF, _min_flood


def rank_labels(labels: torch.Tensor, connectivity: int = 2,
                max_iters: int = 512, max_run: int | None = None):
    """Sequential 1..n relabel of a min-linear-index label image.

    ``labels`` must carry, for every component, the id 1 + the linear index
    of its minimum pixel (what labeling.label produces). The running count
    of representatives is flooded component-wise with a min, so each
    component takes its rank. Returns (seq_labels int32, n_labels int32)."""
    mask = labels > 0
    lin = (torch.arange(labels.numel(), dtype=torch.int32,
                        device=labels.device) + 1).reshape(labels.shape)
    rep = mask & (labels == lin)
    ranks_flat = torch.cumsum(rep.reshape(-1).to(torch.int32), dim=0,
                              dtype=torch.int32)
    n = ranks_flat[-1]
    dense0 = torch.where(mask, ranks_flat.reshape(labels.shape),
                         torch.full_like(labels, _INF))
    rank = _min_flood(dense0, mask, connectivity, max_iters, max_run)
    return torch.where(mask, rank, torch.zeros_like(rank)), n


class LabelStats(NamedTuple):
    counts: torch.Tensor        # (num_segments,) f32 pixel counts
    border_hits: torch.Tensor   # (num_segments,) f32 border-pixel counts
    sums: torch.Tensor          # (num_segments, C) per-channel sums
    spill: bool                 # always False (no window to overflow)
    moments: torch.Tensor | None = None    # (num_segments, 5) r, c, r2, c2, rc
    aux_hist: torch.Tensor | None = None   # (num_segments, A)
    mask_counts: torch.Tensor | None = None  # (num_segments,)


def label_stats_table_plain(labels: torch.Tensor, image, aux, mask,
                            num_segments: int, aux_classes: int,
                            moments: bool, h: int, w: int) -> torch.Tensor:
    """Plain-torch twin of kernel B3: the (num_segments, ncols) f32 table
    [count, border, moments?, channel sums (x mask)?, aux hist?, mask?]
    from flat (N,) labels, (N, C) image, (N,) aux and (N,) mask. The
    moments are int64 sums rounded once to f32, as the kernel's."""
    ids = torch.clamp(labels.to(torch.int64), 0, num_segments - 1)
    sel = torch.nonzero(ids > 0).squeeze(1)
    ids = ids[sel]
    row = sel // w
    col = sel % w
    border = (row == 0) | (row == h - 1) | (col == 0) | (col == w - 1)
    cols = [torch.ones((sel.shape[0], 1), dtype=torch.float32,
                       device=labels.device),
            border.to(torch.float32)[:, None]]
    mom = None
    if moments:
        mom = torch.zeros((num_segments, 5), dtype=torch.int64,
                          device=labels.device).index_add_(
            0, ids, torch.stack([row, col, row * row, col * col, row * col],
                                dim=1))
    mb = None if mask is None else mask[sel].to(torch.float32)
    if image is not None:
        ib = image[sel].to(torch.float32)
        cols.append(ib if mb is None else ib * mb[:, None])
    if aux is not None:
        cls = torch.arange(aux_classes, device=labels.device)
        cols.append((aux[sel].to(torch.int64)[:, None] == cls[None, :])
                    .to(torch.float32))
    if mb is not None:
        cols.append(mb[:, None])
    feat = torch.cat(cols, dim=1)
    acc = torch.zeros((num_segments, feat.shape[1]), dtype=torch.float32,
                      device=labels.device).index_add_(0, ids, feat)
    if mom is None:
        return acc
    return torch.cat([acc[:, :2], mom.to(torch.float32), acc[:, 2:]], dim=1)


def label_stats(labels: torch.Tensor, image: torch.Tensor | None,
                num_segments: int, aux: torch.Tensor | None = None,
                aux_classes: int = 0, moments: bool = False,
                image_mask: torch.Tensor | None = None) -> LabelStats:
    """Per-label [count, border-pixel count, channel sums, moments?, aux
    histogram?, masked count?] in one pass: kernel B3 on CUDA tensors, the
    plain version on CPU tensors. ``image`` is labels.shape + (C,) in f32
    or bf16; ``image_mask`` a labels-shaped 0/1 array."""
    h, w = labels.shape[0], labels.numel() // labels.shape[0]
    flat = labels.reshape(-1).to(torch.int32).contiguous()
    img = None if image is None else \
        image.reshape(flat.shape[0], image.shape[-1]).contiguous()
    auxf = None if aux is None else \
        aux.reshape(-1).to(torch.int32).contiguous()
    mf = None if image_mask is None else \
        image_mask.reshape(-1).to(torch.float32).contiguous()
    if labels.device.type == "cuda":
        if img is not None and img.dtype not in (torch.float32,
                                                 torch.bfloat16):
            img = img.to(torch.float32)
        acc = kernels.label_stats(flat, img, auxf, mf, num_segments,
                                  aux_classes, moments, h, w)
    elif labels.device.type == "cpu":
        acc = label_stats_table_plain(flat, img, auxf, mf, num_segments,
                                      aux_classes, moments, h, w)
    else:
        raise ValueError(f"label_stats: unsupported device {labels.device}")
    nmom = 5 if moments else 0
    nchan = 0 if image is None else image.shape[-1]
    naux = aux_classes if aux is not None else 0
    mom = acc[:, 2:2 + nmom] if moments else None
    sums = acc[:, 2 + nmom:2 + nmom + nchan]
    ah = acc[:, 2 + nmom + nchan:2 + nmom + nchan + naux] \
        if aux is not None else None
    mc = acc[:, -1] if image_mask is not None else None
    return LabelStats(acc[:, 0], acc[:, 1], sums, False, mom, ah, mc)


def label_lookup_plain(labels: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of kernel B4: table[clip(l, 0, n-1)] as f32, 0.0
    where l <= 0."""
    tbl = table.to(torch.float32)
    vals = tbl[torch.clamp(labels.to(torch.int64), 0, tbl.shape[0] - 1)]
    return torch.where(labels > 0, vals, torch.zeros_like(vals))


def label_lookup(labels: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-pixel ``table[labels]`` as float32 (int tables up to 2^24 are
    exact): kernel B4 on CUDA tensors, the plain version on CPU tensors."""
    if labels.device.type == "cuda":
        return kernels.label_lookup(
            labels.to(torch.int32).contiguous(),
            table.to(torch.float32).contiguous())
    if labels.device.type == "cpu":
        return label_lookup_plain(labels, table)
    raise ValueError(f"label_lookup: unsupported device {labels.device}")


def remove_small_holes_fast(mask: torch.Tensor, area_threshold: int = 64,
                            connectivity: int = 1,
                            num_segments: int = 32768,
                            max_iters: int = 512,
                            flood_max_run: int | None = None,
                            exact_fallback: bool = True) -> torch.Tensor:
    """skimage remove_small_holes through one border flood, a CCL + rank
    of the hole pixels only, a count pass (B3) and a lookup (B4).

    The holes' scans are capped at max(8, 4 * sqrt(area_threshold)): a
    longer hole only costs extra fixpoint rounds. With ``num_segments`` or
    more holes the exact morphology.remove_small_holes runs, or, with
    ``exact_fallback=False``, the mask comes back unchanged (the
    reference's choice for callers whose hole count is bounded); the
    branch reads the hole count back to the host."""
    m = mask.to(torch.bool)
    comp = ~m
    reach = lab.flood_reach(lab.border_mask(mask.shape, mask.device), comp,
                            connectivity, max_iters, flood_max_run)
    holes = comp & ~reach
    cap = max(8, 4 * int(float(area_threshold) ** 0.5))
    seq, n = rank_labels(lab.label(holes, connectivity, max_iters, cap),
                         connectivity, max_iters, cap)
    if int(n) < num_segments:
        seqc = torch.clamp(seq, max=num_segments - 1)
        st = label_stats(seqc, None, num_segments)
        hole_tbl = (st.counts < area_threshold).to(torch.float32)
        hole = label_lookup(seqc, hole_tbl) > 0.5
        return m | (hole & holes)
    if exact_fallback:
        return morph.remove_small_holes(m, area_threshold, connectivity)
    return m


def remove_small_objects_fast(mask: torch.Tensor, min_size: int,
                              connectivity: int = 2,
                              num_segments: int = 32768,
                              max_iters: int = 512,
                              exact_fallback: bool = True) -> torch.Tensor:
    """skimage remove_small_objects through a CCL + rank of the mask, a
    count pass (B3) and a keep-table lookup (B4).

    The branch reads the component count back to the host. With
    ``num_segments`` or more components the counts are an exact
    full-size bincount of the component ids instead, or, with
    ``exact_fallback=False``, the mask comes back unchanged (the
    reference's choice for the 3D seeder, whose components are bounded)."""
    lbl = lab.label(mask, connectivity, max_iters)
    seq, n = rank_labels(lbl, connectivity, max_iters)
    if int(n) < num_segments:
        seqc = torch.clamp(seq, max=num_segments - 1)
        st = label_stats(seqc, None, num_segments)
        keep_tbl = (st.counts >= min_size).to(torch.float32)
        return mask & (label_lookup(seqc, keep_tbl) > 0.5)
    if not exact_fallback:
        return mask
    flat, counts = lab._id_counts(lbl)
    return mask & (counts[flat] >= min_size).reshape(mask.shape)


def stats_cm_plain(labels: torch.Tensor, image: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Plain-torch twin of kernel B5: the (num_segments, 1 + C) f32
    [count, channel sums] table from flat (n,) labels and a channels-major
    (C, n) image; ids outside [1, num_segments) add nothing."""
    ids = labels.to(torch.int64)
    sel = torch.nonzero((ids > 0) & (ids < num_segments)).squeeze(1)
    ids = ids[sel]
    acc = torch.zeros((1 + image.shape[0], num_segments), dtype=torch.float32,
                      device=labels.device)
    acc[0].index_add_(0, ids, torch.ones(ids.shape, dtype=torch.float32,
                                         device=labels.device))
    acc[1:].index_add_(1, ids, image[:, sel].to(torch.float32))
    return acc.T.contiguous()


def stats_cm(labels: torch.Tensor, img_cm: torch.Tensor,
             num_segments: int, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Per-label [count, channel sums] of a channels-major image, the
    streamed 3D measurement's reduction: kernel B5 on CUDA tensors, the
    plain version on CPU tensors. ``labels`` any shape; ``img_cm`` (C,) +
    labels.shape in f32 or bf16 (other dtypes go through f32). Returns the
    (num_segments, 1 + C) f32 table, column 0 the count; with ``out``, a
    (num_segments, 1 + C) f32 table, the sums are added into it and it is
    returned (the kernel adds in place; the plain version adds its table).
    Unlike the reference's banded window it cannot spill, so there is no
    spill flag."""
    flat = labels.reshape(-1).to(torch.int32).contiguous()
    img = img_cm.reshape(img_cm.shape[0], flat.shape[0])
    if img.dtype not in (torch.float32, torch.bfloat16):
        img = img.to(torch.float32)
    if labels.device.type == "cuda":
        return kernels.stats_cm(flat, img.contiguous(), num_segments, out)
    if labels.device.type == "cpu":
        acc = stats_cm_plain(flat, img, num_segments)
        return acc if out is None else out.add_(acc)
    raise ValueError(f"stats_cm: unsupported device {labels.device}")
