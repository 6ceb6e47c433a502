"""Frozen copy of hiprfish_tpu_torch/ops/register.py for the benchmark's
plain reference, cut to what the reference calls; it imports nothing of
the port.

FFT phase-correlation translation registration (torch port of
hiprfish_tpu/ops/register.py)."""

from __future__ import annotations

import torch


def register_translation(reference: torch.Tensor,
                         moving: torch.Tensor) -> torch.Tensor:
    """Integer (row, col) shift aligning ``moving`` to ``reference`` as a
    (2,) float32 tensor: argmax of |irfft2| of the normalized cross-power
    spectrum (the first index on ties, as jnp.argmax)."""
    f_ref = torch.fft.rfft2(reference.to(torch.float32))
    f_mov = torch.fft.rfft2(moving.to(torch.float32))
    cross = f_ref * torch.conj(f_mov)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-12)
    cc_abs = torch.abs(torch.fft.irfft2(cross, s=tuple(reference.shape)))
    flat = torch.argmax(cc_abs.reshape(-1))
    w = reference.shape[1]
    maxima = torch.stack([flat // w, flat % w]).to(torch.float32)
    shape = torch.tensor(reference.shape, dtype=torch.float32,
                         device=reference.device)
    midpoints = torch.floor(shape / 2)
    return torch.where(maxima > midpoints, maxima - shape, maxima)


def apply_shift_2d(image: torch.Tensor, shift):
    """Shift an (H, W, ...) image by integer (row, col) and return
    (shifted, valid_mask): zeros outside the overlap, in the image's dtype
    (a bf16 cube stays bf16).

    torch.roll takes host integers, so the shift is read back to the host
    (one sync per call)."""
    sr, sc = (int(v) for v in torch.as_tensor(shift).tolist())
    h, w = image.shape[0], image.shape[1]
    rolled = torch.roll(image, shifts=(sr, sc), dims=(0, 1))
    rows = torch.arange(h, device=image.device)[:, None]
    cols = torch.arange(w, device=image.device)[None, :]
    valid = ((rows - sr >= 0) & (rows - sr < h)
             & (cols - sc >= 0) & (cols - sc < w))
    mask = valid
    if image.ndim > 2:
        valid = valid.reshape(valid.shape + (1,) * (image.ndim - 2))
    return rolled * valid.to(rolled.dtype), mask


def clamp_shift(shift: torch.Tensor, max_shift: float,
                enabled: bool = True) -> torch.Tensor:
    """Zero out implausibly large shifts."""
    if not enabled:
        return shift
    return torch.where(torch.abs(shift) > max_shift,
                       torch.zeros_like(shift), shift)
