"""Synthetic spectral FOVs with known barcodes (numpy; a copy of the grid
mode of hiprfish_tpu/utils/synthetic.py::make_fov, which tests hold equal
to the reference's).

Cells are rotated ellipses on a jittered grid, each carrying the emission
spectrum of its binary barcode; every laser block may be rolled by its own
integer shift to exercise registration.
"""

from __future__ import annotations

import numpy as np

from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT, ChannelLayout

# The flagship FOV fov_step is run and timed on: 2000^2, 7-bit, 400 planted
# cells cycling through the 127 codes, with the per-laser shifts and cell
# axes of bench.py's 7-bit fixture.
FLAGSHIP_SHAPE = (2000, 2000)
FLAGSHIP_CODES = tuple(1 + (i % 127) for i in range(400))
FLAGSHIP_SHIFTS = ((0, 0), (2, -1), (0, 3), (-2, 0))
FLAGSHIP_CELL_AXES = (7.0, 12.0)

# The 10-bit E. coli FOV fov_step_ecoli is run and timed on: bench.py's
# 10-bit configuration, 2000^2, 400 planted cells taking every 37th of the
# 1023 codes, five per-laser shifts, cell axes (9, 14) (minor axis ~18 px,
# inside the shape gate's 15-35 px), seed 2.
ECOLI_SHAPE = (2000, 2000)
ECOLI_CODES = tuple((i * 37) % 1023 + 1 for i in range(400))
ECOLI_SHIFTS = ((0, 0), (2, -1), (0, 3), (-2, 0), (1, 1))
ECOLI_CELL_AXES = (9.0, 14.0)


def fluorophore_spectra(layout: ChannelLayout,
                        sharpness: float = 6.0) -> np.ndarray:
    """(n_bits, C) per-fluorophore emission spectra: fluorophore k emits a
    Gaussian bump inside every laser block whose check-bit group holds k,
    peaking at a distinct channel per fluorophore; unit peak."""
    spectra = np.zeros((layout.n_bits, layout.n_channels), np.float64)
    ch = np.arange(layout.n_channels)
    for block_idx, group in enumerate(layout.check_bit_groups):
        if block_idx >= len(layout.blocks):
            continue  # derived blocks have no channels
        lo, hi = layout.blocks[block_idx]
        width = hi - lo
        for rank, bit in enumerate(sorted(group)):
            center = lo + (rank + 1) / (len(group) + 1) * width
            spectra[bit] += np.exp(
                -((ch - center) ** 2) / (2 * (width / sharpness) ** 2))
    peaks = spectra.max(axis=1, keepdims=True)
    return spectra / np.maximum(peaks, 1e-12)


def barcode_spectrum(layout: ChannelLayout, code: int,
                     spectra: np.ndarray | None = None) -> np.ndarray:
    """(C,) unit-peak spectrum of a barcode: the sum of its fluorophores'."""
    if spectra is None:
        spectra = fluorophore_spectra(layout)
    out = np.zeros(layout.n_channels)
    for k, bit in enumerate(layout.code_str(code)):
        if bit == "1":
            out += spectra[k]
    return out / max(out.max(), 1e-12)


def make_fov(layout: ChannelLayout, barcodes, shape=(256, 256),
             seed: int = 0, laser_shifts=None, cell_axes=(9.0, 15.0)):
    """Per-laser images of a synthetic FOV, one cell per barcode on a
    jittered grid over the whole frame, with uniform noise of amplitude
    0.01 (the reference's defaults brightness=1, noise=0.01).

    Returns a dict: ``stack`` (list of per-laser (H, W, C_l) float32),
    ``truth_labels`` ((H, W) int32, cell i + 1 for barcodes[i]),
    ``truth_barcodes`` and ``spectra`` (the fluorophore spectra).
    """
    rng = np.random.RandomState(seed)
    h, w = shape
    spectra = fluorophore_spectra(layout)
    grid = int(np.ceil(np.sqrt(len(barcodes))))
    margin = max(cell_axes) + 12
    ys = np.linspace(margin, h - margin, grid)
    xs = np.linspace(margin, w - margin, grid)
    jitter_px = 4.0
    yy, xx = np.mgrid[:h, :w]

    image = np.zeros((h, w, layout.n_channels), np.float32)
    truth = np.zeros((h, w), np.int32)
    win = int(np.ceil(max(cell_axes))) + 2
    a, b = cell_axes  # semi-minor, semi-major
    for i, code in enumerate(barcodes):
        cy = ys[i // grid] + rng.uniform(-1, 1) * jitter_px
        cx = xs[i % grid] + rng.uniform(-1, 1) * jitter_px
        theta = rng.uniform(0, np.pi)
        # rasterize only the cell's bounding window
        r0, r1 = max(0, int(cy) - win), min(h, int(cy) + win + 1)
        c0, c1 = max(0, int(cx) - win), min(w, int(cx) + win + 1)
        dy = yy[r0:r1, c0:c1] - cy
        dx = xx[r0:r1, c0:c1] - cx
        u = dy * np.cos(theta) + dx * np.sin(theta)
        v = -dy * np.sin(theta) + dx * np.cos(theta)
        r2 = (u / b) ** 2 + (v / a) ** 2
        inside = r2 <= 1.0
        # a brighter interior, falling to 0.8 at the rim
        profile = np.where(inside, 1.0 - 0.2 * np.sqrt(np.clip(r2, 0, 1)),
                           0.0)
        spec = barcode_spectrum(layout, code, spectra)
        cell_gain = rng.uniform(0.8, 1.2)
        image[r0:r1, c0:c1] += \
            profile[:, :, None] * spec[None, None, :] * cell_gain
        tw = truth[r0:r1, c0:c1]
        tw[inside & (tw == 0)] = i + 1

    noise_rng = np.random.default_rng(seed + 1)
    image += noise_rng.random((h, w, layout.n_channels), np.float32) * 0.01

    stack = []
    for li, (lo, hi) in enumerate(layout.blocks):
        plane = image[:, :, lo:hi]
        if laser_shifts is not None:
            sr, sc = laser_shifts[li]
            plane = np.roll(plane, (int(sr), int(sc)), axis=(0, 1))
        stack.append(plane.astype(np.float32))
    return {"stack": stack, "truth_labels": truth,
            "truth_barcodes": list(barcodes), "spectra": spectra}


def flagship_fov():
    """The flagship FOV (see FLAGSHIP_* above), seed 1."""
    return make_fov(SEVEN_BIT, list(FLAGSHIP_CODES), shape=FLAGSHIP_SHAPE,
                    seed=1, laser_shifts=FLAGSHIP_SHIFTS,
                    cell_axes=FLAGSHIP_CELL_AXES)


def ecoli_fov():
    """The 10-bit E. coli FOV (see ECOLI_* above), seed 2."""
    return make_fov(TEN_BIT, list(ECOLI_CODES), shape=ECOLI_SHAPE, seed=2,
                    laser_shifts=ECOLI_SHIFTS, cell_axes=ECOLI_CELL_AXES)


def write_reference_folder(layout: ChannelLayout, folder: str, encs,
                           cells_per_code: int = 60, seed: int = 0,
                           prefix: str = "08_18_2018", noise: float = 0.02,
                           write_norm: bool = False) -> None:
    """Write synthetic measured-reference CSVs
    ('{prefix}_enc_<n>_avgint.csv', and '..._avgint_norm.csv' with
    ``write_norm``) for each barcode, the files the training builders
    glob: per-cell mean spectra with a random gain and Gaussian noise,
    from RandomState(seed) in the reference's order."""
    import os

    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    spectra = fluorophore_spectra(layout)
    for enc in encs:
        spec = barcode_spectrum(layout, enc, spectra)
        gains = rng.uniform(0.7, 1.3, (cells_per_code, 1))
        rows = gains * spec[None, :] + rng.randn(
            cells_per_code, layout.n_channels) * noise * spec.max()
        rows = np.clip(rows, 0, None)
        path = os.path.join(folder, f"{prefix}_enc_{enc}_avgint.csv")
        np.savetxt(path, rows, delimiter=",")
        if write_norm:
            norm = rows / np.maximum(rows.max(axis=1, keepdims=True), 1e-12)
            np.savetxt(
                os.path.join(folder, f"{prefix}_enc_{enc}_avgint_norm.csv"),
                norm, delimiter=",")


def fixture_training_set(layout: ChannelLayout, spc: int):
    """The simulated training rows of the committed classifier fixtures
    (tools/make_torch_port_fixture.py, bench.py's recipes), from
    RandomState(0): (spectra (n, C'), code strings).

    7-bit: 50 rows per code drawn code by code, gain U(0.7, 1.3) then
    N(0, 0.02) noise, clipped at 0 and row-max normalised. 10-bit: every
    code's gains (1023, spc, 1), then all the noise, clipped and row-max
    normalised, with the violet derivative (np.diff of channels 0-31)
    appended."""
    rng = np.random.RandomState(0)
    lut = fluorophore_spectra(layout)
    n_codes = 2 ** layout.n_bits - 1
    codes = range(1, n_codes + 1)
    code_strs = [layout.code_str(c) for c in codes for _ in range(spc)]
    if layout is SEVEN_BIT:
        rows = []
        for c in codes:
            spec = barcode_spectrum(layout, c, lut)
            r = rng.uniform(0.7, 1.3, (spc, 1)) * spec[None, :] \
                + rng.randn(spc, layout.n_channels) * 0.02
            rows.append(np.clip(r, 0, None))
        spectra = np.concatenate(rows).astype(np.float32)
        spectra = spectra / np.maximum(spectra.max(axis=1, keepdims=True),
                                       1e-12)
        return spectra, code_strs
    base = np.stack([barcode_spectrum(layout, c, lut) for c in codes])
    gains = rng.uniform(0.7, 1.3, (n_codes, spc, 1)).astype(np.float32)
    noise = rng.randn(n_codes, spc, layout.n_channels).astype(np.float32) \
        * 0.02
    spectra = np.clip(gains * base[:, None, :] + noise, 0, None)
    spectra = spectra.reshape(n_codes * spc, layout.n_channels)
    spectra /= np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)
    spectra = np.concatenate(
        [spectra, np.diff(spectra[:, :32], axis=1)], axis=1)
    return spectra, code_strs
