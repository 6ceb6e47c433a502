"""Fast-mode non-local means (torch port of hiprfish_tpu/ops/denoise.py).

``denoise_nl_means`` is the wrapper of kernel B1 (csrc/nlm.cu): the plain
version below on a CPU tensor, the CUDA kernel on a CUDA tensor. Both have
the semantics of the reference's XLA formulation over the whole frame,
border included: reflect pad by pd, roll wrap-around inside the padded
frame, edge-padded box mean, half-window offsets with the mirrored -o term,
self weight 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hiprfish_tpu_torch import kernels


def _box_mean(img: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter with a (size x size) window, edge-padded, same-size out
    (cumulative-sum differences along each axis, as the reference)."""
    half = size // 2
    p = F.pad(img[None, None], (half, half, half, half),
              mode="replicate")[0, 0]
    c = torch.cumsum(p, dim=0)
    c = F.pad(c, (0, 0, 1, 0))
    rows = c[size:, :] - c[:-size, :]
    c2 = torch.cumsum(rows, dim=1)
    c2 = F.pad(c2, (1, 0, 0, 0))
    out = c2[:, size:] - c2[:, :-size]
    return out / (size * size)


def half_offsets(patch_distance: int):
    """The (dy, dx) > (0, 0) half of the search window, in scan order."""
    pd = patch_distance
    return [(dy, dx) for dy in range(-pd, pd + 1)
            for dx in range(-pd, pd + 1) if (dy, dx) > (0, 0)]


def denoise_nl_means_plain(image: torch.Tensor, h: float = 0.02,
                           patch_size: int = 7,
                           patch_distance: int = 11) -> torch.Tensor:
    """Plain-torch fast-mode NLM of an (H, W) image (264 offsets at pd=11,
    each a roll + box filter + exp/accumulate over the padded frame)."""
    img = image.to(torch.float32)
    pd = patch_distance
    padded = F.pad(img[None, None], (pd, pd, pd, pd), mode="reflect")[0, 0]
    h2 = torch.tensor(np.float32(h * h), device=img.device)
    acc = padded.clone()
    wacc = torch.ones_like(padded)
    for dy, dx in half_offsets(pd):
        shifted_img = torch.roll(padded, (dy, dx), dims=(0, 1))
        d2 = _box_mean((padded - shifted_img) ** 2, patch_size)
        wgt = torch.exp(-torch.clamp(d2, min=0.0) / h2)
        acc = acc + wgt * shifted_img
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
