"""FFT phase-correlation translation registration (torch port of
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


def shift_into(out: torch.Tensor, volume: torch.Tensor, shift) -> torch.Tensor:
    """Write ``volume`` shifted by integer ``shift`` (one entry per leading
    axis) into ``out`` of the same shape: out[p] = volume[p - shift] where
    p - shift lies inside the volume, 0 elsewhere (torch.roll times the
    overlap mask, without either full-size temporary). ``out`` may be a
    strided view, such as a channel slice of a larger cube; ``volume`` is
    copied from in its own layout. Returns ``out``."""
    src, dst = [], []
    for ax, o in enumerate(int(v) for v in shift):
        n = volume.shape[ax]
        if abs(o) >= n:
            return out.zero_()
        idx = [slice(None)] * out.ndim
        # the planes the shift leaves without data
        idx[ax] = slice(0, o) if o >= 0 else slice(n + o, n)
        out[tuple(idx)] = 0
        dst.append(slice(max(o, 0), n + min(o, 0)))
        src.append(slice(max(-o, 0), n - max(o, 0)))
    out[tuple(dst)] = volume[tuple(src)]
    return out


def apply_shift_3d(volume: torch.Tensor, shift):
    """Shift an (X, Y, Z, ...) volume by integer (x, y, z) and return
    (shifted, valid_mask (X, Y, Z)): zeros outside the overlap, in the
    volume's dtype. The shift is read back to the host once, as in
    apply_shift_2d."""
    sx, sy, sz = (int(v) for v in torch.as_tensor(shift).tolist())
    x, y, z = volume.shape[0], volume.shape[1], volume.shape[2]
    out = shift_into(torch.empty_like(volume), volume, (sx, sy, sz))
    dev = volume.device
    xi = torch.arange(x, device=dev)[:, None, None]
    yi = torch.arange(y, device=dev)[None, :, None]
    zi = torch.arange(z, device=dev)[None, None, :]
    mask = ((xi - sx >= 0) & (xi - sx < x) & (yi - sy >= 0) & (yi - sy < y)
            & (zi - sz >= 0) & (zi - sz < z))
    return out, mask


def clamp_shift(shift: torch.Tensor, max_shift: float,
                enabled: bool = True) -> torch.Tensor:
    """Zero out implausibly large shifts."""
    if not enabled:
        return shift
    return torch.where(torch.abs(shift) > max_shift,
                       torch.zeros_like(shift), shift)


def register_translation_3d(reference: torch.Tensor,
                            moving: torch.Tensor) -> torch.Tensor:
    """Integer 3D shift aligning ``moving`` to ``reference`` as a (3,)
    float32 tensor: argmax of |ifftn| of the normalized cross-power
    spectrum (first index on ties), wrapped to (-shape/2, shape/2]."""
    f_ref = torch.fft.fftn(reference.to(torch.float32))
    f_mov = torch.fft.fftn(moving.to(torch.float32))
    cross = f_ref * torch.conj(f_mov)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-12)
    cc_abs = torch.abs(torch.fft.ifftn(cross))
    flat = torch.argmax(cc_abs.reshape(-1))
    shape = torch.tensor(reference.shape, dtype=torch.int64,
                         device=reference.device)
    idx = []
    for s in reversed(reference.shape):
        idx.append(flat % s)
        flat = flat // s
    maxima = torch.stack(idx[::-1]).to(torch.float32)
    shape = shape.to(torch.float32)
    midpoints = torch.floor(shape / 2)
    return torch.where(maxima > midpoints, maxima - shape, maxima)


def register_stack_2d(images_sum, max_shift: float | None = 15.0):
    """(n, 2) float32 shifts of a sequence of (H, W) projections against the
    first one (first row zeros), each zeroed where it exceeds ``max_shift``
    unless that is None."""
    ref = images_sum[0]
    shifts = [torch.zeros((2,), dtype=torch.float32, device=ref.device)]
    for img in images_sum[1:]:
        s = register_translation(ref, img)
        if max_shift is not None:
            s = clamp_shift(s, max_shift)
        shifts.append(s)
    return torch.stack(shifts)
