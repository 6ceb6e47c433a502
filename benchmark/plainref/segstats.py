"""Frozen copy of the plain per-label statistics, lookup, sequential ranking
and small-hole removal of hiprfish_tpu_torch/ops/segstats.py (the twins of
kernels B3 and B4: ``label_stats_table_plain``, ``label_lookup_plain``)
and the per-region double erosion of pipeline/segment2d.py, for the
benchmark's plain reference; it imports nothing of the port.

Every column whose terms are integers (count, border, moments, aux
histogram, a 0/1 mask's count) is exact; ids are clipped to
[0, num_segments - 1], label 0 never accumulates, and a lookup gives 0.0
for label <= 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import labeling as lab
from . import morphology as morph
from .labeling import _INF, _min_flood


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
    histogram?, masked count?] in one pass on the labels' device."""
    h, w = labels.shape[0], labels.numel() // labels.shape[0]
    flat = labels.reshape(-1).to(torch.int32).contiguous()
    img = None if image is None else \
        image.reshape(flat.shape[0], image.shape[-1]).contiguous()
    auxf = None if aux is None else \
        aux.reshape(-1).to(torch.int32).contiguous()
    mf = None if image_mask is None else \
        image_mask.reshape(-1).to(torch.float32).contiguous()
    acc = label_stats_table_plain(flat, img, auxf, mf, num_segments,
                                  aux_classes, moments, h, w)
    nmom = 5 if moments else 0
    nchan = 0 if image is None else image.shape[-1]
    naux = aux_classes if aux is not None else 0
    mom = acc[:, 2:2 + nmom] if moments else None
    sums = acc[:, 2 + nmom:2 + nmom + nchan]
    ah = acc[:, 2 + nmom + nchan:2 + nmom + nchan + naux] \
        if aux is not None else None
    mc = acc[:, -1] if image_mask is not None else None
    return LabelStats(acc[:, 0], acc[:, 1], sums, False, mom, ah, mc)


def label_lookup(labels: torch.Tensor, table: torch.Tensor,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain-torch twin of kernel B4: table[clip(l, 0, n-1)] as f32, 0.0
    where l <= 0, cast to ``out_dtype`` when given."""
    tbl = table.to(torch.float32)
    vals = tbl[torch.clamp(labels.to(torch.int64), 0, tbl.shape[0] - 1)]
    out = torch.where(labels > 0, vals, torch.zeros_like(vals))
    return out if out_dtype is None else out.to(out_dtype)


def remove_small_holes_fast(mask: torch.Tensor, area_threshold: int = 64,
                            connectivity: int = 1,
                            num_segments: int = 32768,
                            max_iters: int = 512,
                            flood_max_run: int | None = None
                            ) -> torch.Tensor:
    """skimage remove_small_holes through one border flood, a CCL + rank
    of the hole pixels only, a count pass (B3) and a lookup (B4).

    The holes' scans are capped at max(8, 4 * sqrt(area_threshold)): a
    longer hole only costs extra fixpoint rounds. With ``num_segments`` or
    more holes the mask comes back unchanged (the port's
    ``exact_fallback=False``, the one choice its E. coli step makes); the
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
    return m


def erode_labels_twice(labels: torch.Tensor) -> torch.Tensor:
    """Per-region double erosion of a label image: a pixel survives a pass
    iff its whole cross neighbourhood in the previous pass's labels carries
    its label (out-of-image counts as the same)."""
    out = labels
    for _ in range(2):
        cur = out
        for off in morph._cross_shifts(labels.ndim):
            nb = lab.shifted(cur, off, -1)
            same = (nb == cur) | (nb == -1)
            out = torch.where(same, out, torch.zeros_like(out))
        out = torch.where(cur > 0, out, torch.zeros_like(out))
    return out
