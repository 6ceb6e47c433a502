"""The comparison that decides ``correct``: a FOV's result from the timed
path against the plain reference's result for the same planes.

Cells are matched by their pixels, not their ids: a program cell and a
reference cell pair up when each is the other's largest overlap. Of a
FOV it measures

* ``px_gap``: the pixels on which the two segmentations disagree, that is
  every pixel that either labels and that does not lie in the overlap of
  a matched pair (0 when the partitions are equal);
* ``cells_changed``: the cells of either side whose pixels are not exactly
  those of a cell of the other side (2 for one pixel moved across a
  boundary, 3 for two cells merged into one);
* ``cells_gap``: the difference of the cell counts;
* ``spectra_gap``: over pairs with the same pixels, the largest channel
  difference of the mean spectra relative to the reference row's peak;
* ``vote_gap``: over pairs with the same pixels, the largest difference
  between the program's vote fraction for the barcode it called and the
  reference's vote fraction for that same barcode (about 1 where the call
  differs).
"""

from __future__ import annotations

import numpy as np

NAMES = ("px_gap", "cells_changed", "cells_gap", "spectra_gap", "vote_gap")


def _best(a: np.ndarray, b: np.ndarray, cnt: np.ndarray) -> dict:
    """{a id: b id of its largest overlap} (ties to the lower b id)."""
    order = np.lexsort((-b, cnt, a))      # by a, then count, then -b
    last = np.ones(len(order), bool)
    last[:-1] = a[order][1:] != a[order][:-1]
    sel = order[last]
    return dict(zip(a[sel].tolist(), b[sel].tolist()))


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of one FOV. ``prog`` and ``ref`` hold the host
    results: ``labels`` (H, W), ``n_cells``, and for cells 1..n the rows
    ``avgint``, ``code`` and ``prob``; ``ref`` also ``scores`` (n,
    classes)."""
    pl = prog["labels"].reshape(-1).astype(np.int64)
    rl = ref["labels"].reshape(-1).astype(np.int64)
    fg = (pl > 0) | (rl > 0)
    pairs, cnt = np.unique((pl[fg] << 32) | rl[fg], return_counts=True)
    p, r = pairs >> 32, pairs & 0xFFFFFFFF
    both = (p > 0) & (r > 0)
    p_best = _best(p[both], r[both], cnt[both])
    r_best = _best(r[both], p[both], cnt[both])
    size_p = np.bincount(p, weights=cnt)
    size_r = np.bincount(r, weights=cnt)
    agree = 0
    ident = []
    for (pi, ri), c in zip(zip(p[both].tolist(), r[both].tolist()),
                           cnt[both].tolist()):
        if p_best.get(pi) == ri and r_best.get(ri) == pi:
            agree += c
            if c == size_p[pi] == size_r[ri]:
                ident.append((pi, ri))
    n_p, n_r = int(prog["n_cells"]), int(ref["n_cells"])
    out = {"px_gap": int(fg.sum()) - agree,
           "cells_changed": n_p + n_r - 2 * len(ident),
           "cells_gap": abs(n_p - n_r), "spectra_gap": 0.0, "vote_gap": 0.0,
           "cells_identical": len(ident), "cells_ref": n_r}
    if ident:
        ip = np.asarray([a for a, _ in ident]) - 1
        ir = np.asarray([b for _, b in ident]) - 1
        a_p = prog["avgint"][ip].astype(np.float64)
        a_r = ref["avgint"][ir].astype(np.float64)
        peak = np.maximum(np.abs(a_r).max(axis=1), 1e-30)
        out["spectra_gap"] = float((np.abs(a_p - a_r).max(axis=1)
                                    / peak).max())
        code = prog["code"][ip].astype(np.int64)
        ref_vote = ref["scores"][ir, code]
        out["vote_gap"] = float(np.abs(prog["prob"][ip].astype(np.float64)
                                       - ref_vote).max())
    return out


def worst(checks: list) -> dict:
    """The largest of each number over several FOVs."""
    out = {}
    for c in checks:
        for k, v in c.items():
            out[k] = max(out.get(k, v), v) if k in NAMES else \
                min(out.get(k, v), v)
    return out
