"""Sample-name parsers and the table readers of the experiments (a copy
of the name helpers of hiprfish_tpu/io/tables.py; the probe design and
the mix tables the training builders read, with the csv module in place
of pandas)."""

from __future__ import annotations

import csv
import re

import numpy as np

_INT = re.compile(r"^\s*[+-]?[0-9]+\s*$")


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


def _typed_column(texts):
    """A CSV column as pandas' read_csv types it: int64 when every field
    is an integer, float64 (empty fields NaN) when every field is a
    number, else the text (empty fields stay empty)."""
    if texts and all(_INT.match(t) for t in texts):
        return np.array([int(t) for t in texts], np.int64)
    try:
        return np.array([float(t) if t != "" else np.nan for t in texts],
                        np.float64)
    except ValueError:
        return np.array(texts, dtype=object)


def read_columns(path: str, text_columns=()) -> dict:
    """A CSV table as {column: numpy array}, in the file's column order;
    the ``text_columns`` stay text (leading zeros kept), the others are
    typed as pandas' read_csv types them."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    cols = {}
    for j, name in enumerate(header):
        texts = [r[j] if j < len(r) else "" for r in body]
        cols[name] = (np.array(texts, dtype=object) if name in text_columns
                      else _typed_column(texts))
    return cols


def read_probe_design(path: str) -> dict:
    """Probe-design CSV as {column: numpy array}; ``code`` stays text."""
    return read_columns(path, ("code",))


def read_mix_barcodes(path: str) -> list:
    """The barcodes of a mix table: its ``Barcodes`` column as ints."""
    return [int(b) for b in read_columns(path)["Barcodes"]]
