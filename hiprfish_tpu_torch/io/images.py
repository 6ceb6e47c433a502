"""Spectral image planes and z-stacks (a copy of the loaders of
hiprfish_tpu/io/images.py): ``.npy`` with numpy, ``.tif`` through imageio,
imported only when a ``.tif`` is read. The Zeiss ``.czi`` reader is not
ported yet (ROADMAP §A.7) and raises."""

from __future__ import annotations

import os

import numpy as np


def load_image(filename: str) -> np.ndarray:
    """One (H, W, C) image plane."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".npy":
        return np.asarray(np.load(filename))
    if ext == ".czi":
        raise _czi_not_ported(filename)
    if ext in (".tif", ".tiff"):
        import imageio.v3 as iio

        arr = np.asarray(iio.imread(filename))
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    raise ValueError(f"unsupported image format: {filename}")


def _czi_not_ported(filename: str):
    return NotImplementedError(
        f"{filename}: the .czi reader is not ported yet (ROADMAP §A.7); "
        "convert the planes to .npy")


def load_image_stack(filenames) -> list:
    """Per-laser image planes of one FOV."""
    return [load_image(f) for f in filenames]


def load_image_zstack_fixed_t(filename: str) -> np.ndarray:
    """(X, Y, Z, C) z-stack at the first time point: a ``.npy`` stored as
    (Z, H, W, C) becomes (H, W, Z, C)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".npy":
        arr = np.load(filename)
        if arr.ndim == 4:
            return np.moveaxis(arr, 0, 2)
        raise ValueError(f"npy z-stack must be (Z, H, W, C): {filename}")
    if ext == ".czi":
        raise _czi_not_ported(filename)
    raise ValueError(filename)


def load_calibration_image(filename: str) -> np.ndarray:
    return np.load(filename)


def build_calibration_cube(calibration_image: np.ndarray, n_channels: int,
                           block_end: int = 32) -> np.ndarray:
    """An (H, W, n_channels) float32 cube of ones with the flat-field image
    in channels [0, block_end) (only the 405 nm block is corrected)."""
    cal = np.ones(
        (calibration_image.shape[0], calibration_image.shape[1], n_channels),
        np.float32,
    )
    cal[:, :, :block_end] = calibration_image[:, :, None]
    return cal
