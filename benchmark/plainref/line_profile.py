"""Frozen copy of the 2D plain LP-CV of hiprfish_tpu_torch/ops/line_profile.py
(``lp_cv_enhance_2d_plain``, the twin of kernel B2, with its line table and
quartile helpers) for the benchmark's plain reference; it imports nothing
of the port. ``selection_network`` and ``quartile_ranks`` also serve the
frozen work counts of ``benchmark/kernel_work.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F



def _line_coords_1axis(interval: int, line_n: int, li: int,
                       increment: int) -> int:
    """Patch coordinate along one axis for sample ``li`` of a line."""
    sign = int(np.sign(interval))
    h = sign * li * (2 * abs(interval) + 1) / line_n
    return int(np.sign(h) * np.floor(abs(h)) + increment - interval)



def line_table_2d(patch_size: int = 11, phi_range: int = 9) -> np.ndarray:
    """(phi_range, patch_size, 2) int patch coordinates of the 2D stencil:
    for orientation phi and sample li, the (row, col) within the patch."""
    increment = (patch_size - 1) // 2
    table = np.zeros((phi_range, patch_size, 2), dtype=np.int64)
    for phi in range(phi_range):
        ivals = np.array([
            int(np.round(increment * np.cos(phi * np.pi / phi_range))),
            int(np.round(increment * np.sin(phi * np.pi / phi_range))),
        ])
        max_interval = ivals[np.argmax(np.abs(ivals))]
        line_n = int(2 * abs(max_interval) + 1)
        if line_n < patch_size:
            diff = (patch_size - line_n) // 2
            for li in range(line_n):
                for a in range(2):
                    table[phi, li + diff, a] = _line_coords_1axis(
                        ivals[a], line_n, li, increment)
            table[phi, :diff] = table[phi, diff]
            table[phi, line_n + diff:] = table[phi, line_n + diff - 1]
        else:
            for li in range(line_n):
                for a in range(2):
                    table[phi, li, a] = _line_coords_1axis(
                        ivals[a], line_n, li, increment)
    return table



def _batcher_comparators(n: int):
    """Batcher odd-even mergesort comparators (ascending) for n inputs,
    generated for the next power of two with the pairs that touch an index
    >= n dropped (+inf padding makes them no-ops)."""
    p2 = 1
    while p2 < n:
        p2 *= 2
    comps = []
    p = 1
    while p < p2:
        k = p
        while k >= 1:
            for j in range(k % p, p2 - k, 2 * k):
                for i in range(k):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        if i + j + k < n:
                            comps.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return comps



def selection_network(n: int, outputs) -> list:
    """The comparators of the Batcher network that can change the given
    output ranks (a backward prune): applied in order they leave the k-th
    smallest value at index k for every k in ``outputs``."""
    needed = set(outputs)
    kept = []
    for a, b in reversed(_batcher_comparators(n)):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.update((a, b))
    return kept[::-1]



def quartile_ranks(t: int):
    """((lo25, hi25, f25), (lo75, hi75, f75)): the sorted ranks and weights
    of the interpolated 25th/75th percentiles of t values."""
    q25, q75 = 0.25 * (t - 1), 0.75 * (t - 1)
    lo25, hi25 = int(np.floor(q25)), int(np.ceil(q25))
    lo75, hi75 = int(np.floor(q75)), int(np.ceil(q75))
    return (lo25, hi25, q25 - lo25), (lo75, hi75, q75 - lo75)



def _lp_cv_combine(rnc_stack: torch.Tensor,
                   mean: torch.Tensor | None = None) -> torch.Tensor:
    """mean(rnc) * (1 - quartile CV) over the last axis (T orientations);
    ``mean`` is the mean of the orientations, if the caller has it."""
    if mean is None:
        mean = torch.mean(rnc_stack, dim=-1)
    s = torch.sort(rnc_stack, dim=-1).values
    (lo25, hi25, f25), (lo75, hi75, f75) = quartile_ranks(rnc_stack.shape[-1])
    lq = s[..., lo25] * (1 - f25) + s[..., hi25] * f25
    uq = s[..., lo75] * (1 - f75) + s[..., hi75] * f75
    qcv = torch.where(uq > 0, (uq - lq) / (uq + lq + 1e-8),
                      torch.zeros_like(uq))
    return mean * (1.0 - qcv)



def lp_cv_enhance_2d(image: torch.Tensor, patch_size: int = 11,
                           phi_range: int = 9) -> torch.Tensor:
    """Plain-torch LP-CV: edge pad, per-orientation min/max/centre over
    shifted views, normalize, combine. The orientations' mean is their sum
    in order times the float32 reciprocal of phi_range, as the reference's
    CPU program computes it."""
    pad = (patch_size - 1) // 2
    img = image.to(torch.float32)
    padded = F.pad(img[None, None], (pad, pad, pad, pad),
                   mode="replicate")[0, 0]
    table = line_table_2d(patch_size, phi_range)
    h, w = img.shape
    rnc = []
    for t in range(phi_range):
        vmin = vmax = vcenter = None
        for li in range(patch_size):
            di, dj = int(table[t, li, 0]), int(table[t, li, 1])
            v = padded[di:di + h, dj:dj + w]
            vmin = v if vmin is None else torch.minimum(vmin, v)
            vmax = v if vmax is None else torch.maximum(vmax, v)
            if li == pad:
                vcenter = v
        rng = torch.clamp(vmax - vmin, min=1e-8)
        rnc.append((vcenter - vmin) / rng)
    total = rnc[0]
    for r in rnc[1:]:
        total = total + r
    return _lp_cv_combine(torch.stack(rnc, dim=-1),
                          total * np.float32(1.0 / phi_range))
