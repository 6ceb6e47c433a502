"""Connected-component labeling by iterative min-label propagation, and
the label-table filters built on it (torch port of
hiprfish_tpu/ops/labeling.py).

Every fixpoint loop keeps the reference's cap and exit rule: stop when an
iteration changed nothing or after ``max_iters`` iterations. The change
test reads one boolean back to the host per iteration (a sync per round);
capturing the loop in a CUDA graph is later work.
"""

from __future__ import annotations

import itertools

import torch

_INF = 2**30


def _neighbor_shifts(ndim: int, connectivity: int):
    """Offsets of the neighborhood (excluding center)."""
    shifts = []
    for off in itertools.product((-1, 0, 1), repeat=ndim):
        if all(o == 0 for o in off):
            continue
        if sum(abs(o) for o in off) <= connectivity:
            shifts.append(off)
    return shifts


def shifted(arr: torch.Tensor, off, fill) -> torch.Tensor:
    """out[p] = arr[p - off], ``fill`` where p - off leaves the array."""
    out = torch.full_like(arr, fill)
    dst, src = [], []
    for ax, o in enumerate(off):
        n = arr.shape[ax]
        if abs(o) >= n:
            return out
        if o >= 0:
            dst.append(slice(o, n))
            src.append(slice(0, n - o))
        else:
            dst.append(slice(0, n + o))
            src.append(slice(-o, n))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _run_min_scan(values: torch.Tensor, mask: torch.Tensor, axis: int,
                  reverse: bool, max_run: int | None = None) -> torch.Tensor:
    """Running min of ``values`` along contiguous True-runs of ``mask``
    (Hillis-Steele doubling, distance capped at ``max_run``)."""
    off = [0] * mask.ndim
    off[axis] = -1 if reverse else 1
    gate = mask & shifted(mask, tuple(off), False)
    n = values.shape[axis]
    if max_run is not None:
        n = min(n, max_run)
    g, v = gate, values
    d = 1
    while d < n:
        off_d = [0] * mask.ndim
        off_d[axis] = -d if reverse else d
        ga = shifted(g, tuple(off_d), False)
        va = shifted(v, tuple(off_d), _INF)
        v = torch.where(g, torch.minimum(va, v), v)
        g = g & ga
        d *= 2
    return torch.where(mask, v, values)


def _run_or_scan(reach: torch.Tensor, mask: torch.Tensor, axis: int,
                 reverse: bool, max_run: int | None = None) -> torch.Tensor:
    """Propagate True along contiguous mask runs (segmented OR-scan)."""
    off = [0] * mask.ndim
    off[axis] = -1 if reverse else 1
    gate = mask & shifted(mask, tuple(off), False)
    n = reach.shape[axis]
    if max_run is not None:
        n = min(n, max_run)
    g, r = gate, reach
    d = 1
    while d < n:
        off_d = [0] * mask.ndim
        off_d[axis] = -d if reverse else d
        ga = shifted(g, tuple(off_d), False)
        ra = shifted(r, tuple(off_d), False)
        r = r | (g & ra)
        g = g & ga
        d *= 2
    return r


def _block_pool(x: torch.Tensor, c: int, op: str) -> torch.Tensor:
    """Factor-c block reduce per axis (padded with False — conservative)."""
    pads = [(-s) % c for s in x.shape]
    if any(pads):
        padded = torch.zeros([s + p for s, p in zip(x.shape, pads)],
                             dtype=x.dtype, device=x.device)
        padded[tuple(slice(0, s) for s in x.shape)] = x
        x = padded
    comb = torch.logical_and if op == "all" else torch.logical_or
    for ax in range(x.ndim):
        sl = [slice(None)] * x.ndim
        r = None
        for k in range(c):
            sl[ax] = slice(k, None, c)
            piece = x[tuple(sl)]
            r = piece if r is None else comb(r, piece)
        x = r
    return x


def flood_reach(seeds: torch.Tensor, mask: torch.Tensor,
                connectivity: int = 1, max_iters: int = 512,
                max_run: int | None = None) -> torch.Tensor:
    """Pixels of ``mask`` reachable from ``seeds`` through ``mask``.

    Inputs of >= 2^22 pixels first flood a coarse grid of fully-inside-mask
    4-blocks and add the reached blocks as seeds (exact: the fine loop still
    runs to its fixed point)."""
    c = 4
    if seeds.numel() >= (1 << 22) and all(s >= 4 * c for s in mask.shape):
        solid = _block_pool(mask, c, "all")
        cseeds = _block_pool(seeds & mask, c, "any") & solid
        creach = _flood_reach_flat(cseeds, solid, 1, max_iters, max_run)
        up = creach
        for ax, s in enumerate(mask.shape):
            idx = torch.arange(s, device=mask.device) // c
            up = torch.index_select(up, ax, idx)
        seeds = seeds | (up & mask)
    return _flood_reach_flat(seeds, mask, connectivity, max_iters, max_run)


def _flood_reach_flat(seeds: torch.Tensor, mask: torch.Tensor,
                      connectivity: int = 1, max_iters: int = 512,
                      max_run: int | None = None) -> torch.Tensor:
    ndim = mask.ndim
    shifts = [s for s in _neighbor_shifts(ndim, connectivity)
              if sum(abs(o) for o in s) >= 2]
    reach = seeds & mask
    changed, it = True, 0
    while changed and it < max_iters:
        cur = reach
        nb = cur
        for off in shifts:
            nb = nb | shifted(cur, off, False)
        cur = mask & (cur | nb)
        for axis in range(ndim):
            cur = _run_or_scan(cur, mask, axis, False, max_run)
            cur = _run_or_scan(cur, mask, axis, True, max_run)
        changed = bool((cur != reach).any())  # host sync
        reach, it = cur, it + 1
    return reach


def _window_pool(x: torch.Tensor, reduce_fn, fill) -> torch.Tensor:
    """Exact reduce over the full 3^ndim neighborhood (separable)."""
    for ax in range(x.ndim):
        off_p = [0] * x.ndim
        off_p[ax] = 1
        off_m = [0] * x.ndim
        off_m[ax] = -1
        x = reduce_fn(reduce_fn(x, shifted(x, tuple(off_p), fill)),
                      shifted(x, tuple(off_m), fill))
    return x


def border_mask(shape, device=None) -> torch.Tensor:
    border = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for ax in range(len(shape)):
        idx = [slice(None)] * len(shape)
        idx[ax] = 0
        border[tuple(idx)] = True
        idx[ax] = shape[ax] - 1
        border[tuple(idx)] = True
    return border


def _min_flood(init: torch.Tensor, mask: torch.Tensor, connectivity: int,
               max_iters: int, max_run: int | None) -> torch.Tensor:
    """Iterate neighbor-min + segmented min-scans to the fixed point (the
    shared body of label and segstats.rank_labels)."""
    ndim = mask.ndim
    shifts = [s for s in _neighbor_shifts(ndim, connectivity)
              if sum(abs(o) for o in s) >= 2]
    full_conn = connectivity == ndim
    inf = torch.full_like(init, _INF)
    lbl = init
    changed, it = True, 0
    while changed and it < max_iters:
        cur = lbl
        if full_conn:
            cur = torch.where(mask, _window_pool(cur, torch.minimum, _INF),
                              inf)
        else:
            nb = cur
            for off in shifts:
                nb = torch.minimum(nb, shifted(cur, off, _INF))
            cur = torch.where(mask, torch.minimum(cur, nb), inf)
        for axis in range(ndim):
            cur = _run_min_scan(cur, mask, axis, False, max_run)
            cur = _run_min_scan(cur, mask, axis, True, max_run)
        changed = bool((cur != lbl).any())  # host sync
        lbl, it = cur, it + 1
    return lbl


def label(mask: torch.Tensor, connectivity: int | None = None,
          max_iters: int = 512, max_run: int | None = None) -> torch.Tensor:
    """Label connected components of a boolean mask (int32). Each id is 1 +
    the linear index of the component's minimum pixel."""
    if connectivity is None:
        connectivity = mask.ndim
    lin = (torch.arange(mask.numel(), dtype=torch.int32, device=mask.device)
           + 1).reshape(mask.shape)
    lbl0 = torch.where(mask, lin, torch.full_like(lin, _INF))
    lbl = _min_flood(lbl0, mask, connectivity, max_iters, max_run)
    return torch.where(mask, lbl, torch.zeros_like(lbl))


def _id_counts(labels: torch.Tensor):
    """(flat ids clipped to [0, numel], per-id pixel counts): the
    reference's scatter tables of labels.numel() + 1 entries."""
    size = labels.numel()
    flat = torch.clamp(labels.reshape(-1).to(torch.int64), 0, size)
    return flat, torch.bincount(flat, minlength=size + 1)


def relabel_sequential(labels: torch.Tensor):
    """Remap positive labels to 1..n keeping their order (skimage
    relabel_sequential). Returns (new_labels int32, n_labels int32)."""
    size = labels.numel()
    flat = labels.reshape(-1).to(torch.int64)
    flat_c = torch.clamp(flat, 0, size)
    presence = torch.zeros(size + 1, dtype=torch.int32, device=labels.device)
    presence[flat_c] = 1
    presence[0] = 0
    newid = torch.cumsum(presence, dim=0, dtype=torch.int32)
    out = newid[flat_c] * (flat > 0)
    return out.reshape(labels.shape), newid[-1]


def clear_border(labels: torch.Tensor) -> torch.Tensor:
    """Zero every component touching the image border (skimage
    clear_border)."""
    size = labels.numel()
    flat = torch.clamp(labels.reshape(-1).to(torch.int64), 0, size)
    border = border_mask(labels.shape, labels.device).reshape(-1)
    marked = torch.zeros(size + 1, dtype=torch.bool, device=labels.device)
    marked[flat[border]] = True
    marked[0] = False
    drop = marked[flat].reshape(labels.shape)
    return torch.where(drop, torch.zeros_like(labels), labels)


def remove_small_objects(mask: torch.Tensor, min_size: int,
                         connectivity: int | None = None) -> torch.Tensor:
    """Drop connected components smaller than ``min_size`` from a boolean
    mask (skimage remove_small_objects)."""
    flat, counts = _id_counts(label(mask, connectivity))
    return mask & (counts[flat] >= min_size).reshape(mask.shape)


def filter_and_relabel(labels: torch.Tensor, min_size: int,
                       drop_border: bool = True):
    """remove_small_labels + clear_border + relabel_sequential in one
    counts pass, one border pass, a cumsum and one gather. Returns
    (new_labels int32, n_labels int32)."""
    flat, counts = _id_counts(labels)
    keep = counts >= min_size
    if drop_border:
        border = border_mask(labels.shape, labels.device).reshape(-1)
        keep[flat[border]] = False
    keep[0] = False
    newid = torch.cumsum(keep.to(torch.int32), dim=0, dtype=torch.int32)
    value_tbl = torch.where(keep, newid, torch.zeros_like(newid))
    return value_tbl[flat].reshape(labels.shape), newid[-1]


def remove_small_labels(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Zero label regions smaller than ``min_size``, keeping the remaining
    ids (skimage remove_small_objects on a label image)."""
    flat, counts = _id_counts(labels)
    keep = (counts[flat] >= min_size).reshape(labels.shape)
    return torch.where(keep, labels, torch.zeros_like(labels))
