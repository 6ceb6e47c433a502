"""Fast-mode non-local means (torch port of hiprfish_tpu/ops/denoise.py).

``denoise_nl_means`` is the wrapper of kernel B1 (csrc/nlm.cu): the plain
version below on a CPU tensor, the CUDA kernel on a CUDA tensor. Both have
the semantics of the reference's XLA formulation over the whole frame,
border included: reflect pad by pd, roll wrap-around inside the padded
frame, edge-padded box mean, half-window offsets with the mirrored -o term,
self weight 1. The plain version rounds as the reference's CPU program
does, on any device: its cumulative sums, exp and fused multiply-adds
with denormals flushed (ops/fp.py), h^2 squared in float32 and the box
sum times the float32 reciprocal of its area. On the CPU it gives that
program's bits; on the card it is the kernel's twin.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.ops import fp

# offsets whose weights the plain version computes at once: its ~250
# operations per weight field then launch once per 16 offsets on the card
OFFSET_BATCH = 16


def _box_mean(img: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter with a (size x size) window over the last two axes,
    edge-padded, same-size out (cumulative-sum differences along each
    axis, as the reference)."""
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


def denoise_nl_means_plain(image: torch.Tensor, h: float = 0.02,
                           patch_size: int = 7,
                           patch_distance: int = 11) -> torch.Tensor:
    """Plain-torch fast-mode NLM of an (H, W) image (264 offsets at pd=11,
    each a roll + box filter + exp/accumulate over the padded frame). The
    weights of OFFSET_BATCH offsets are computed at once; they accumulate
    one offset at a time, in scan order."""
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


def denoise_nl_means(image: torch.Tensor, h: float = 0.02,
                     patch_size: int = 7,
                     patch_distance: int = 11) -> torch.Tensor:
    """Kernel B1 on a CUDA tensor, the plain version on a CPU tensor."""
    if image.device.type == "cuda":
        return kernels.nlm(image.to(torch.float32).contiguous(), h,
                           patch_size, patch_distance)
    if image.device.type == "cpu":
        return denoise_nl_means_plain(image, h, patch_size, patch_distance)
    raise ValueError(f"denoise_nl_means: unsupported device {image.device}")


# the name the LP-CV engine calls; the device of the tensor picks B1 or
# the plain version, so there is nothing more to dispatch on
denoise_nl_means_auto = denoise_nl_means
