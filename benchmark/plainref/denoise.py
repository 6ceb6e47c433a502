"""Frozen copy of the plain fast-mode NLM of hiprfish_tpu_torch/ops/denoise.py
(``denoise_nl_means_plain``, the twin of kernel B1) for the benchmark's
plain reference; it imports nothing of the port.

The reference's XLA formulation over the whole frame, border included:
reflect pad by pd, roll wrap-around inside the padded frame, edge-padded
box mean, half-window offsets with the mirrored -o term, self weight 1,
with the reference CPU program's roundings (``fp``) on any device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import fp

# offsets whose weights are computed at once
OFFSET_BATCH = 16


def _box_mean(img: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter with a (size x size) window over the last two axes,
    edge-padded, same-size out (cumulative-sum differences)."""
    half = size // 2
    p = F.pad(img[..., None, :, :], (half, half, half, half),
              mode="replicate")[..., 0, :, :]
    c = fp.cumsum_in_order(p, -2)
    c = F.pad(c, (0, 0, 1, 0))
    rows = c[..., size:, :] - c[..., :-size, :]
    c2 = fp.cumsum_in_order(rows, -1)
    c2 = F.pad(c2, (1, 0, 0, 0))
    out = c2[..., size:] - c2[..., :-size]
    return out * np.float32(1.0 / (size * size))


def half_offsets(patch_distance: int):
    """The (dy, dx) > (0, 0) half of the search window, in scan order."""
    pd = patch_distance
    return [(dy, dx) for dy in range(-pd, pd + 1)
            for dx in range(-pd, pd + 1) if (dy, dx) > (0, 0)]


def denoise_nl_means(image: torch.Tensor, h: float = 0.02,
                     patch_size: int = 7,
                     patch_distance: int = 11) -> torch.Tensor:
    """Fast-mode NLM of an (H, W) image on the image's device."""
    img = image.to(torch.float32)
    pd = patch_distance
    padded = F.pad(img[None, None], (pd, pd, pd, pd), mode="reflect")[0, 0]
    h32 = torch.tensor(np.float32(h), device=img.device)
    h2 = h32 * h32
    acc = padded.clone()
    wacc = torch.ones_like(padded)
    offsets = half_offsets(pd)
    for lo in range(0, len(offsets), OFFSET_BATCH):
        group = offsets[lo:lo + OFFSET_BATCH]
        shifted = torch.stack([torch.roll(padded, o, dims=(0, 1))
                               for o in group])
        d2 = _box_mean((padded - shifted) ** 2, patch_size)
        wgts = fp.exp(-torch.clamp(d2, min=0.0) / h2)
        for (dy, dx), wgt, shifted_img in zip(group, wgts, shifted):
            acc = fp.fma(wgt, shifted_img, acc)
            wacc = wacc + wgt
            acc = acc + torch.roll(wgt * padded, (-dy, -dx), dims=(0, 1))
            wacc = wacc + torch.roll(wgt, (-dy, -dx), dims=(0, 1))
    out = acc / torch.clamp(wacc, min=1e-12)
    return out[pd:-pd, pd:-pd]
