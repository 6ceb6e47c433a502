"""Experiment-level collection of per-FOV results (the port of
hiprfish_tpu/pipeline/collect.py, with numpy and the csv module in place
of pandas):

  * reference mode ('R'): per-sample barcode error rate against the known
    encoding, zero error reported as the 1/N upper limit, and the one-,
    two- and multi-bit error shares;
  * mix mode ('M'): per-FOV barcode counts merged into the
    n_barcodes-row abundance table.

A table is an ordered {column: numpy array} (io/tables.read_image_table).
The CSVs are the bytes pandas' to_csv writes for the reference's frames:
the input columns as read_csv typed them, the added count columns int64,
the per-row columns set only where a _cell_ids.txt exists NaN (an empty
field) elsewhere, an abundance column float64 once a barcode lacked a
count.
"""

from __future__ import annotations

import os
import re

import numpy as np

from hiprfish_tpu_torch.io import outputs, tables


def _data_lines(path: str) -> list:
    """The non-blank lines of a headerless CSV; a file with none raises
    ValueError, as pandas' EmptyDataError does."""
    with open(path, newline="") as f:
        lines = [line for line in f.read().splitlines() if line]
    if not lines:
        raise ValueError(f"{path}: no columns to parse from file")
    return lines


def _read_cell_ids(path: str) -> np.ndarray:
    """The barcodes of a _cell_ids.txt as text (leading zeros kept, NA
    tokens NaN), one per non-blank line."""
    lines = _data_lines(path)
    if any("," in line for line in lines):
        raise ValueError(f"{path}: expected one barcode per line")
    return tables.text_column(lines)


def _set(cols: dict, name: str, i: int, value, n: int) -> None:
    """cols[name][i] = value as pandas' ``.loc[i, name] = value`` sets it:
    a new column is NaN elsewhere (float64, or text for a string), an
    int64 column takes a float value as float64 and any column a string
    as text."""
    col = cols.get(name)
    if col is None:
        col = np.full(n, np.nan, dtype=object if isinstance(value, str)
                      else np.float64)
    elif isinstance(value, str) and col.dtype != object:
        col = col.astype(object)
    elif col.dtype.kind in "iub" and not isinstance(value, (int, np.integer)):
        col = col.astype(np.float64)
    col[i] = value
    cols[name] = col


def bit_error_counts(measured, expected: str):
    """(one_bit, two_bit, multi_bit) error tallies via per-position bit
    differences."""
    one = two = multi = 0
    exp_bits = np.array([int(b) for b in expected])
    for code in measured:
        bits = np.array([int(b) for b in str(code)])
        nerr = int(np.abs(bits - exp_bits).sum())
        if nerr == 0:
            continue
        if nerr == 1:
            one += 1
        elif nerr == 2:
            two += 1
        else:
            multi += 1
    return one, two, multi


def collect_reference_measurement_results(data_dir: str,
                                          simulation_table: str,
                                          output_filename: str,
                                          n_bits: int = 10) -> dict:
    """Known-barcode error-rate collection (reference mode). Writes and
    returns the table."""
    sim_tab = tables.read_image_table(simulation_table)
    n = tables.n_rows(sim_tab)
    for name in ("NCells", "BarcodeComplexity", "Barcodes"):
        sim_tab[name] = np.zeros(n, np.int64)
    for i in range(n):
        folder = sim_tab["SAMPLE"][i]
        image_name = sim_tab["IMAGES"][i]
        enc = tables.parse_encoding(image_name)
        code = format(enc, f"0{n_bits}b")
        _set(sim_tab, "Barcodes", i, enc, n)
        _set(sim_tab, "BarcodeComplexity", i, sum(int(b) for b in code), n)
        meas = os.path.join(data_dir, folder, image_name + "_avgint.csv")
        ids_path = os.path.join(data_dir, folder,
                                image_name + "_cell_ids.txt")
        if os.path.exists(meas):
            _set(sim_tab, "NCells", i, len(_data_lines(meas)), n)
        if os.path.exists(ids_path):
            ids = _read_cell_ids(ids_path)
            n_ids = ids.shape[0]
            error_rate = 1 - np.sum(ids == code) / n_ids
            if error_rate == 0:
                _set(sim_tab, "ErrorRate", i, 1 / n_ids, n)
                _set(sim_tab, "ErrorRateUpperLimit", i, "T", n)
            else:
                _set(sim_tab, "ErrorRate", i, error_rate, n)
                _set(sim_tab, "ErrorRateUpperLimit", i, "F", n)
            one, two, multi = bit_error_counts(ids[ids != code], code)
            _set(sim_tab, "OneBitError", i, one / n_ids, n)
            _set(sim_tab, "TwoBitError", i, two / n_ids, n)
            _set(sim_tab, "MultipleBitError", i, multi / n_ids, n)
    outputs.write_frame(output_filename, list(sim_tab.items()))
    return sim_tab


def _fov_counts(barcodes: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """One FOV's column of the abundance table: the count of each barcode
    of ``barcodes`` among the ids, as pandas' left merge of the ids'
    value_counts then fillna(0) gives it (float64 once a barcode has no
    count, else int64)."""
    counts = {}
    for code in ids:
        if not tables.is_na(code):
            value = int(code, 2)
            counts[value] = counts.get(value, 0) + 1
    col = np.array([counts.get(int(b), np.nan) for b in barcodes],
                   np.float64)
    if np.isnan(col).any():
        return np.nan_to_num(col, nan=0.0)
    return col.astype(np.int64)


def collect_mix_measurement_results(data_dir: str, simulation_table: str,
                                    output_filename: str,
                                    n_barcodes: int = 1023) -> dict:
    """Mix-experiment abundance collection (mix mode). Writes the table
    and its _abundance.csv; returns the table."""
    sim_tab = tables.read_image_table(simulation_table)
    n = tables.n_rows(sim_tab)
    sim_tab["NCells"] = np.zeros(n, np.int64)
    sim_tab["FOV"] = np.zeros(n, np.int64)
    abundance = {"Barcodes": np.arange(1, n_barcodes + 1, dtype=np.int64)}
    for i in range(n):
        folder = sim_tab["SAMPLE"][i]
        image_name = sim_tab["IMAGES"][i]
        _set(sim_tab, "FOV", i, tables.parse_fov(image_name), n)
        meas = os.path.join(data_dir, folder, image_name + "_avgint.csv")
        ids_path = os.path.join(data_dir, folder,
                                image_name + "_cell_ids.txt")
        if os.path.exists(meas):
            _set(sim_tab, "NCells", i, len(_data_lines(meas)), n)
        if os.path.exists(ids_path):
            abundance[f"FOV{i + 1}"] = _fov_counts(
                abundance["Barcodes"], _read_cell_ids(ids_path))
    abundance_filename = re.sub(r"\.csv$", "_abundance.csv",
                                output_filename)
    outputs.write_frame(output_filename, list(sim_tab.items()))
    outputs.write_frame(abundance_filename, list(abundance.items()))
    return sim_tab
