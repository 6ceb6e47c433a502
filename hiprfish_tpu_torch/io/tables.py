"""Sample-name parsers of the experiment tables (a copy of the name
helpers of hiprfish_tpu/io/tables.py, without its pandas table reader)."""

from __future__ import annotations

import re


def parse_encoding(image_name: str) -> int:
    """The barcode id of an 'enc_<n>' tag in a sample name."""
    m = re.search(r"enc_([0-9]+)", image_name)
    if m is None:
        raise ValueError(f"no enc_<n> tag in {image_name!r}")
    return int(m.group(1))


def parse_fov(image_name: str) -> int:
    m = re.search(r"fov_([0-9]+)", image_name)
    if m is None:
        raise ValueError(f"no fov_<n> tag in {image_name!r}")
    return int(m.group(1))


def sample_from_image_name(image_name: str) -> str:
    """Strip the '_<laser>.<ext>' suffix of a per-laser image name."""
    return re.sub(r"_[0-9]*\.(czi|npy|tif|tiff)$", "", image_name)
