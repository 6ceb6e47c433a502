"""Configuration of the port (a copy of the parts of hiprfish_tpu/config.py
that its slices read).

``SEVEN_BIT`` is the 4-laser, 63-channel layout, ``TEN_BIT`` the 5-laser,
95-channel one, ``SegmentationConfig`` holds the segmentation
parameters ``pipeline/fused.py``, ``pipeline/fused_ecoli.py``,
``pipeline/segment2d.py`` and ``pipeline/segment3d.py`` read, and
``ClassifierConfig`` the training parameters of ``models/classifier.py``
and ``models/train.py``, all with the reference's defaults. Tests hold
them, and the barcode converters, equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ChannelLayout:
    """Spectral channel layout of one experiment family."""

    name: str                      # stored in classifier artifacts
    lasers: Tuple[str, ...]        # excitation wavelengths, nm, as named
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


# 5 lasers: 405, 488, 514, 561, 633 nm; the sixth check group belongs to
# the violet-derivative block, which has no channels of its own
TEN_BIT = ChannelLayout(
    name="10bit",
    lasers=("405", "488", "514", "561", "633"),
    n_channels=95,
    block_bounds=(0, 32, 55, 75, 89, 95),
    n_bits=10,
    check_bit_groups=(
        (1, 5, 6),          # c1: 405 block
        (9, 2, 0),          # c2: 488 block
        (9, 0, 2, 8, 7),    # c3: 514 block
        (7, 8),             # c4: 561 block
        (3, 4),             # c5: 633 block
        (1,),               # c6: violet-derivative block
    ),
)

# 4 lasers: 488, 514, 561, 633 nm
SEVEN_BIT = ChannelLayout(
    name="7bit",
    lasers=("488", "514", "561", "633"),
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

# bits of the 10-bit code the 7-bit subset keeps
SEVEN_BIT_SUBSET = (0, 2, 3, 4, 7, 8, 9)


def convert_code_to_7b(code: str) -> str:
    """Project a 10-bit barcode string onto the 7-bit fluorophore subset."""
    return "".join(code[i] for i in SEVEN_BIT_SUBSET)


def convert_code_to_10b(code: str) -> str:
    """Embed a 7-bit barcode string into the 10-bit space, zeros on the
    bits the subset drops (the inverse of convert_code_to_7b)."""
    out = ["0"] * 10
    for bit, i in zip(code, SEVEN_BIT_SUBSET):
        out[i] = bit
    return "".join(out)


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Parameters of the LP-CV and erosion-seeded segmentations."""

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
    # E. coli erosion-seeded watershed: components below seed_area_max
    # become seeds, seeds below seed_min_size and watershed regions below
    # cell_min_size are dropped, cells keep a minor axis in [min, max], and
    # the erosion loop runs at most max_erosion_iters rounds
    seed_area_max: int = 600
    seed_min_size: int = 10
    cell_min_size: int = 100
    minor_axis_min: float = 15.0
    minor_axis_max: float = 35.0
    max_erosion_iters: int = 40
    # size gates of the LP-CV seeds and cells
    lp_seed_min_size: int = 10
    lp_cell_min_size: int = 60
    # caps of the fixpoint loops (watershed flood, label propagation) and
    # the doubling cap of the id floods' segmented scans
    watershed_max_iters: int = 256
    ccl_max_iters: int = 512
    scan_cap: int = 16
    # biofilm: the epithelial area (background objects below bkg_min_size
    # dropped, closed and dilated by a disk of epithelial_disk_radius) and
    # the debris filter (area above debris_area_max, or a classification
    # probability at most debris_prob_min)
    bkg_min_size: int = 10000
    epithelial_disk_radius: int = 100
    debris_area_max: int = 10000
    debris_prob_min: float = 0.95


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Parameters of classifier training and inference."""

    n_neighbors: int = 25
    simulations_per_code: int = 2000
    # the check-bit heads: one hidden layer, trained by Adam;
    # models/classifier.train_check_heads batches by 4096 rows whatever
    # check_batch says, as the reference's trainer does
    check_hidden: int = 64
    check_train_steps: int = 1000
    check_lr: float = 3e-3
    check_batch: int = 4096
    # the kNN vote's softmax temperature
    knn_temperature: float = 300.0
    # spectra simulation: per-block excitation scale U(low, high) and the
    # FRET builder's Foerster distance U(low, high)
    excitation_adjust_low: float = 0.4
    excitation_adjust_high: float = 1.0
    fret_distance_low: float = 6.0
    fret_distance_high: float = 10.0
    dtype: str = "float32"
