"""Configuration of the port's 7-bit slice (a copy of the parts of
hiprfish_tpu/config.py that the slice reads).

``SEVEN_BIT`` is the 4-laser, 63-channel layout and ``SegmentationConfig``
holds the segmentation parameters ``pipeline/fused.py::fov_step`` and
``pipeline/segment3d.py`` read, with the reference's defaults. Tests hold
both equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ChannelLayout:
    """Spectral channel layout of one experiment family."""

    n_channels: int
    block_bounds: Tuple[int, ...]  # len == n_lasers + 1
    n_bits: int
    # OR-groups of barcode bit indices defining each per-laser check bit
    check_bit_groups: Tuple[Tuple[int, ...], ...]

    @property
    def blocks(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (self.block_bounds[i], self.block_bounds[i + 1])
            for i in range(len(self.block_bounds) - 1)
        )

    def code_str(self, enc: int) -> str:
        """Zero-padded binary barcode string, e.g. 5 -> '0000101'."""
        return format(enc, "0{}b".format(self.n_bits))


# 4 lasers: 488, 514, 561, 633 nm
SEVEN_BIT = ChannelLayout(
    n_channels=63,
    block_bounds=(0, 23, 43, 57, 63),
    n_bits=7,
    check_bit_groups=(
        (6, 1, 0),          # c1: 488 block
        (6, 0, 1, 4, 5),    # c2: 514 block
        (4, 5),             # c3: 561 block
        (2, 3),             # c4: 633 block
    ),
)


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Parameters of the LP-CV segmentation in fov_step."""

    # line-profile stencil; theta_range is 3D only (orientations =
    # (theta_range - 1) * phi_range)
    patch_size: int = 11
    phi_range: int = 9
    theta_range: int = 9
    # registration: integer shift clamp, and the centred crop the FFT
    # correlation runs on (0 correlates the full frame)
    max_shift: int = 15
    clamp_shift: bool = True
    register_crop: int = 512
    # storage dtype of the registered cube, which feeds only the per-cell
    # spectral sums; the NLM/KMeans input stays float32
    registered_dtype: str = "bfloat16"
    # NL-means
    nlm_h: float = 0.02
    nlm_patch_size: int = 7
    nlm_patch_distance: int = 11
    kmeans_iters: int = 40
    # size gates of seeds and cells
    lp_seed_min_size: int = 10
    lp_cell_min_size: int = 60
    # caps of the fixpoint loops (watershed flood, label propagation) and
    # the doubling cap of the id floods' segmented scans
    watershed_max_iters: int = 256
    ccl_max_iters: int = 512
    scan_cap: int = 16
