"""Frozen copy of the plain 3D LP-CV of hiprfish_tpu_torch/ops/line_profile.py
(``line_table_3d`` and ``lp_cv_enhance_3d_plain``, the twin of kernel B6)
for the benchmark's plain reference; it imports nothing of the port.

The volume arrives and the result returns in the 3D pass's canonical
(X, Z, Y) layout; the stencil's axes are (x, y, z) all the same. It is
computed in slabs of ``chunk_x`` x-planes, each with the stencil's halo,
which bound the (chunk_x, Z, Y, 72) orientation stack and do not change
the result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .line_profile import _line_coords_1axis, _lp_cv_combine


def line_table_3d(patch_size: int = 11, theta_range: int = 9,
                  phi_range: int = 9) -> np.ndarray:
    """((theta_range-1)*phi_range, patch_size, 3) int patch coordinates of
    the 3D stencil: for orientation t and sample li, the (x, y, z) within
    the patch."""
    increment = (patch_size - 1) // 2
    n_orient = (theta_range - 1) * phi_range
    table = np.zeros((n_orient, patch_size, 3), dtype=np.int64)
    for theta in range(1, theta_range):
        st = np.sin(theta * np.pi / theta_range)
        for phi in range(phi_range):
            t = (theta - 1) * phi_range + phi
            ivals = np.array([
                int(np.round(increment * np.cos(phi * np.pi / phi_range)
                             * st)),
                int(np.round(increment * np.sin(phi * np.pi / phi_range)
                             * st)),
                int(np.round(increment * np.cos(theta * np.pi
                                                / theta_range))),
            ])
            max_interval = ivals[np.argmax(np.abs(ivals))]
            line_n = int(2 * abs(max_interval) + 1)
            diff = (patch_size - line_n) // 2 if line_n < patch_size else 0
            for li in range(line_n):
                for a in range(3):
                    table[t, li + diff, a] = _line_coords_1axis(
                        ivals[a], line_n, li, increment)
            if diff:
                table[t, :diff] = table[t, diff]
                table[t, line_n + diff:] = table[t, line_n + diff - 1]
    return table


def lp_cv_enhance_3d(vol_xzy: torch.Tensor, patch_size: int = 11,
                     theta_range: int = 9, phi_range: int = 9,
                     bf16: bool = True, chunk_x: int = 32) -> torch.Tensor:
    """3D LP-CV of an (X, Z, Y) volume, f32 (X, Z, Y) out: edge padding,
    then per orientation the min and max over its samples and the
    normalised centre sample (centre - min) / max(max - min, 1e-8), and
    mean(.) x (1 - quartile CV) over the orientations. ``bf16``: the
    samples are the volume rounded to bfloat16 (the configuration's B6
    sample storage); everything after the rounding is float32."""
    vol = vol_xzy.to(torch.float32)
    if bf16:
        vol = vol.to(torch.bfloat16).to(torch.float32)
    x, z, y = vol.shape
    pad = (patch_size - 1) // 2
    padded = F.pad(vol[None, None], (pad,) * 6, mode="replicate")[0, 0]
    table = line_table_3d(patch_size, theta_range, phi_range)
    out = torch.empty((x, z, y), dtype=torch.float32, device=vol.device)
    for x0 in range(0, x, chunk_x):
        cx = min(chunk_x, x - x0)
        block = padded[x0:x0 + cx + 2 * pad]
        rnc = []
        for t in range(table.shape[0]):
            vmin = vmax = vcen = None
            for li in range(patch_size):
                dx, dy, dz = (int(v) for v in table[t, li])
                v = block[dx:dx + cx, dz:dz + z, dy:dy + y]
                vmin = v if vmin is None else torch.minimum(vmin, v)
                vmax = v if vmax is None else torch.maximum(vmax, v)
                if li == pad:
                    vcen = v
            rnc.append((vcen - vmin) / torch.clamp(vmax - vmin, min=1e-8))
        out[x0:x0 + cx] = _lp_cv_combine(torch.stack(rnc, dim=-1))
        del rnc
    return out
