"""Experiment tables and pipeline configuration files (the port of
hiprfish_tpu/io/tables.py, with the csv module in place of pandas).

Keeps the reference's interfaces: the Snakemake JSON config
(hiprfish_config_imaging.json keys __default__.SCRIPTS_PATH / DATA_DIR /
PROBE_DESIGN_DIR, images.image_list_table / image_type), the experiment
CSV tables (SAMPLE, IMAGES, CALIBRATION, CALIBRATION_FILENAME,
REFERENCE_FOLDER[, SPC, INPUT_TAB_FILENAME, REFERENCE_*]), the
classifier filename conventions, the probe design and the mix tables.

A table is an ordered {column: numpy array}, typed as pandas' read_csv
types it (see typed_column), so that a value read here formats, compares
and writes back as the reference's does.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import re
from typing import Optional

import numpy as np

_INT = re.compile(r"^\s*[+-]?[0-9]+\s*$")
_FLOAT = re.compile(
    r"^\s*[+-]?(([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?|inf|infinity)"
    r"\s*$", re.IGNORECASE)
_TRUE = ("True", "TRUE", "true")
_FALSE = ("False", "FALSE", "false")
# pandas' default NA tokens (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


@dataclasses.dataclass
class WorkflowConfig:
    scripts_path: str
    data_dir: str
    image_list_table: str
    image_type: str  # 'R' reference | 'M' mix
    probe_design_dir: Optional[str] = None

    @classmethod
    def from_json(cls, path: str) -> "WorkflowConfig":
        with open(path) as f:
            cfg = json.load(f)
        default = cfg.get("__default__", {})
        images = cfg.get("images", {})
        return cls(
            scripts_path=default.get("SCRIPTS_PATH", ""),
            data_dir=default.get("DATA_DIR", ""),
            image_list_table=images.get("image_list_table", ""),
            image_type=images.get("image_type", "R"),
            probe_design_dir=default.get("PROBE_DESIGN_DIR"),
        )


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


# powers of ten for _parse_float
_E10 = tuple(float(f"1e{k}") for k in range(309))


def _parse_float(text: str) -> float:
    """A decimal field as pandas' C parser reads it (its precise_xstrtod,
    which is not always correctly rounded): the first 17 digits gathered
    in a double, then one multiply or divide by a power of ten; inf and
    infinity as Python reads them."""
    s = text.strip()
    if s.lstrip("+-").lower() in ("inf", "infinity"):
        return float(s)
    p, n = 0, len(s)
    negative = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, n_digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if n_digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            n_digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while n_digits < 17 and p < n and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            n_digits += 1
            exponent -= 1
            p += 1
        while p < n and s[p].isdigit():
            p += 1
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        exponent += int(s[p + 1:])
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _E10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _E10[-308 - exponent] / _E10[308]
    return number / _E10[-exponent]


def is_na(value) -> bool:
    """pandas.isna of one cell: None or a float NaN."""
    return value is None or (isinstance(value, (float, np.floating))
                             and math.isnan(value))


def typed_column(texts):
    """A CSV column as pandas' read_csv types it: the NA tokens are
    missing; bool when every other field is True/False, int64 when every
    field is an integer, float64 (missing fields NaN, the others as
    _parse_float reads them) when every other field is a number (a column
    with no value at all too); else text with NaN for the missing fields
    (bool and NaN likewise stay objects)."""
    present = [t for t in texts if t not in NA_VALUES]
    n_missing = len(texts) - len(present)
    if present and all(t in _TRUE or t in _FALSE for t in present):
        if n_missing == 0:
            return np.array([t in _TRUE for t in texts], bool)
        return np.array([np.nan if t in NA_VALUES else t in _TRUE
                         for t in texts], dtype=object)
    if n_missing == 0 and present and all(_INT.match(t) for t in present):
        return np.array([int(t) for t in texts], np.int64)
    if all(_FLOAT.match(t) for t in present):
        return np.array([np.nan if t in NA_VALUES else _parse_float(t)
                         for t in texts], np.float64)
    return text_column(texts)


def text_column(texts) -> np.ndarray:
    """A column read as text (pandas' dtype=str): an object array of the
    fields as they are, NaN for the NA tokens."""
    out = np.empty(len(texts), dtype=object)
    out[:] = [np.nan if t in NA_VALUES else t for t in texts]
    return out


def read_columns(path: str, text_columns=()) -> dict:
    """A CSV table as {column: numpy array}, in the file's column order;
    the ``text_columns`` stay text (leading zeros kept), the others are
    typed as pandas' read_csv types them. Blank lines are skipped; a file
    with no line at all raises ValueError, as pandas' EmptyDataError
    does."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: no columns to parse from file")
    header, body = rows[0], [r for r in rows[1:] if r]
    cols = {}
    for j, name in enumerate(header):
        texts = [r[j] if j < len(r) else "" for r in body]
        cols[name] = (text_column(texts) if name in text_columns
                      else typed_column(texts))
    return cols


def read_image_table(path: str) -> dict:
    """The experiment table, typed as pandas' read_csv types it."""
    return read_columns(path)


def n_rows(table: dict) -> int:
    return len(next(iter(table.values()))) if table else 0


def table_row(table: dict, i: int) -> dict:
    """Row ``i`` of a table as {column: value}."""
    return {name: col[i] for name, col in table.items()}


def channel_image_filenames(data_dir: str, folder: str, sample: str,
                            lasers) -> list:
    """Per-laser CZI paths, '{data_dir}/{folder}/{sample}_{laser}.czi'."""
    return [
        os.path.join(data_dir, folder, "{}_{}.czi".format(sample, exc))
        for exc in lasers
    ]


def reference_clf_path(data_dir: str, ref_folder: str, spc) -> str:
    """The ecoli classifier filename convention."""
    return os.path.join(
        data_dir,
        str(ref_folder),
        "reference_simulate_{}_excitation_adjusted_normalized_"
        "violet_derivative_umap_transform.pkl".format(spc),
    )


def _row_get(row, key, default=None):
    """Column lookup on a table row (a dict) with a default for missing
    columns and missing values (tables from the ecoli pipeline lack the
    REFERENCE_* dispatch columns entirely)."""
    try:
        val = row[key]
    except (KeyError, IndexError):
        return default
    if is_na(val):
        return default
    return val


def reference_clf_path_from_row(data_dir: str, row) -> str:
    """The reference's whole classifier-filename convention tree: dispatch
    on REFERENCE_TYPE 'A' / REFERENCE_NORMALIZATION / REFERENCE_SCOPE
    'Select' (mix id parsed from INPUT_TAB_FILENAME) / REFERENCE_UMAP.

    ``row`` is one experiment-table row (table_row, or any dict). Missing
    columns and values default to the ecoli convention (normalized, umap,
    full scope).
    """
    ref_folder = _row_get(row, "REFERENCE_FOLDER", "")
    spc = _row_get(row, "SPC", 2000)
    ref_type = _row_get(row, "REFERENCE_TYPE", "S")
    ref_norm = _row_get(row, "REFERENCE_NORMALIZATION", "T")
    ref_scope = _row_get(row, "REFERENCE_SCOPE", "All")
    ref_umap = _row_get(row, "REFERENCE_UMAP", "T")

    def path(name: str) -> str:
        return os.path.join(data_dir, str(ref_folder), name)

    mix_id = None
    if ref_scope == "Select":
        tab = str(_row_get(row, "INPUT_TAB_FILENAME", ""))
        m = re.search(r"mix_([0-9]+)", tab)
        if m is None:
            raise ValueError(
                "REFERENCE_SCOPE='Select' requires a 'mix_<n>' tag in "
                f"INPUT_TAB_FILENAME (got {tab!r})")
        mix_id = int(m.group(1))

    if ref_type == "A":
        return path("reference_all.pkl")
    if ref_norm == "T":
        if ref_scope == "Select":
            return path(
                "reference_simulate_select_mix_{}_{}_normalized_"
                "umap_transform.pkl".format(mix_id, spc))
        if ref_umap == "T":
            return path(
                "reference_simulate_{}_excitation_adjusted_normalized_"
                "violet_derivative_umap_transform.pkl".format(spc))
        return path(
            "reference_simulate_{}_normalized_excitation_adjusted.pkl"
            .format(spc))
    if ref_scope == "Select":
        return path("reference_simulate_select_mix_{}_{}.pkl".format(
            mix_id, spc))
    return path("reference_simulate_{}.pkl".format(spc))


def read_probe_design(path: str) -> dict:
    """Probe-design CSV as {column: numpy array}; ``code`` stays text."""
    return read_columns(path, ("code",))


def read_mix_barcodes(path: str) -> list:
    """The barcodes of a mix table: its ``Barcodes`` column as ints."""
    return [int(b) for b in read_columns(path)["Barcodes"]]
