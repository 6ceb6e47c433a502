"""Per-cell spectral classification of a measured FOV (torch port of
hiprfish_tpu/pipeline/classify.py).

* ``classify_ecoli``: the 10-bit path. Reads {sample}_avgint.csv and
  {sample}_seg.npy, renormalises the spectra, classifies them (95 channels
  + 31 violet-derivative + 6 check bits) and writes _cell_ids.txt,
  _avgint_ids.csv and _identification.png.
* ``classify_spectra_7b``: the 7-bit path. Reads {sample}_avgint_norm.csv
  (with its header) and _seg.npy and writes _cell_information.csv: 63
  features + 4 check bits, barcode, sample, label and seven shape columns.
* ``classify_ecoli_legacy`` and ``classify_spectra_7b_legacy``: the same
  artifacts from the reference's own pickled UMAP stacks
  (models/umap_infer.py).

The spectra are divided by their row max in float64 and only then cast to
float32, as the reference does before its device arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from hiprfish_tpu_torch.io import outputs, tables
from hiprfish_tpu_torch.models import classifier, umap_infer
from hiprfish_tpu_torch.ops import regionprops as rp
from hiprfish_tpu_torch.utils.logging import stage_timer

# the shape columns of the 7-bit cell table, in order
SHAPE_COLUMNS = ("centroid_r", "centroid_c", "major_axis_length",
                 "minor_axis_length", "eccentricity", "orientation", "area")


def paint_identification(segmentation: np.ndarray, codes, n_cells: int):
    """Barcode-valued identification image: the cell with sequential label
    i + 1 painted with int(code, 2)."""
    lut = np.zeros(n_cells + 1, np.int64)
    for i, c in enumerate(codes):
        lut[i + 1] = int(str(c).split("_")[0], 2)
    seg = np.asarray(segmentation)
    return lut[np.clip(seg, 0, n_cells)]


def _row_max_normalize(avgint: np.ndarray) -> np.ndarray:
    return avgint / np.maximum(avgint.max(axis=1, keepdims=True), 1e-12)


def _read_spectra_as_pandas(path: str, header: bool = False) -> np.ndarray:
    """(n, C) float64 rows of a spectra CSV parsed as pandas' default
    read_csv parses them (io/tables._parse_float: one float64 ulp off the
    correctly rounded value on some %.18e fields). The legacy routes write
    these values back out in float64 (10-bit) or round them to float32."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise ValueError(f"{path}: no columns to parse from file")
    ncols = len(lines[0].split(","))
    body = lines[1:] if header else lines
    return np.array([[tables._parse_float(t) for t in line.split(",")]
                     for line in body], np.float64).reshape(len(body), ncols)


def _id_columns(feats: np.ndarray, codes, sample: str) -> np.ndarray:
    """The text cells [features, barcode, sample, 1-based label]: the
    features as numpy's float32 repr (the reference concatenates them with
    the barcode strings into one string array)."""
    n = len(codes)
    return np.concatenate([
        np.asarray(feats).astype(str), np.array(codes, dtype=str)[:, None],
        np.full((n, 1), sample), np.arange(1, n + 1).astype(str)[:, None]],
        axis=1)


def classify_ecoli(avgint_filename: str, clf, device=torch.device("cuda")):
    """Classify one measured FOV's spectra (10-bit path) with a
    models/artifacts.ClassifierArrays on ``device``. Returns the barcode
    strings."""
    sample = avgint_filename[: -len("_avgint.csv")]
    avgint = outputs.read_spectra_csv(avgint_filename)
    segmentation = np.load(sample + "_seg.npy")
    codes, _, _, feats = classifier.classify(
        clf, _row_max_normalize(avgint), device)

    outputs.save_cell_ids(sample + "_cell_ids.txt", codes)
    outputs.write_csv(sample + "_avgint_ids.csv",
                      _id_columns(feats, codes, sample))
    outputs.save_identification_png(
        paint_identification(segmentation, codes, len(codes)), sample)
    return codes


def _write_cell_information(sample: str, feats, codes, segmentation,
                            device) -> None:
    """{sample}_cell_information.csv: the feature columns, barcode,
    sample, 1-based label and the seven shape columns of the labels."""
    n = len(codes)
    max_cells = 1 << max(4, int(np.ceil(np.log2(n + 2))))
    props = rp.shape_props_2d(torch.from_numpy(segmentation).to(device),
                              max_cells)
    shape_cols = np.stack([props[k][1:n + 1].cpu().numpy()
                           for k in SHAPE_COLUMNS], axis=1)
    outputs.write_csv(sample + "_cell_information.csv", np.concatenate(
        [_id_columns(feats, codes, sample),
         outputs.cells_as_text(shape_cols)], axis=1))


def classify_spectra_7b(input_spectra: str, clf,
                        device=torch.device("cuda")):
    """Classify one FOV's 7-bit spectra and write the cell_information
    table (no identification render, as the reference's default). Returns
    the barcode strings."""
    sample = input_spectra[: -len("_avgint_norm.csv")]
    avgint = outputs.read_spectra_csv(input_spectra, header=True)
    segmentation = np.load(sample + "_seg.npy")
    codes, _, _, feats = classifier.classify(
        clf, _row_max_normalize(avgint), device)
    _write_cell_information(sample, feats, codes, segmentation, device)
    return codes


def classify_ecoli_legacy(avgint_filename: str, transform_path: str,
                          save_png: bool = True,
                          device=torch.device("cuda"), negatives=None,
                          timings: dict | None = None):
    """Classify one FOV (10-bit) with the reference's 3-pickle UMAP stack
    on ``device``: 95 channels + 31 violet derivative + 6 check bits ->
    UMAP embedding -> embedded SVC. _avgint_ids.csv holds the float64
    features with the check columns 126-131 at zero, as the JAX package
    writes them (the predicted bits fill a float32 copy). ``negatives``
    goes to umap_transform; ``timings`` receives the seconds of "load",
    the stack's stages and "write". Returns the barcode strings."""
    device = torch.device(device)
    lap = stage_timer(timings, device)
    sample = avgint_filename[: -len("_avgint.csv")]
    avgint = _read_spectra_as_pandas(avgint_filename)
    segmentation = np.load(sample + "_seg.npy")
    avgint_norm = _row_max_normalize(avgint)
    n = avgint_norm.shape[0]
    feats = np.concatenate(
        [avgint_norm, np.zeros((n, 37), np.float32)], axis=1)
    feats[:, 95:126] = np.diff(feats[:, 0:32], axis=1)
    stack = umap_infer.load_legacy_umap_stack(transform_path, device=device)
    lap("load")
    codes = np.asarray(stack.predict(feats, negatives=negatives,
                                     timings=timings)).astype(str)
    lap = stage_timer(timings, device)
    outputs.save_cell_ids(sample + "_cell_ids.txt", codes)
    outputs.write_csv(sample + "_avgint_ids.csv",
                      _id_columns(feats, codes, sample))
    if save_png:
        outputs.save_identification_png(
            paint_identification(segmentation, codes, n), sample)
    lap("write")
    return codes


def classify_spectra_7b_legacy(input_spectra: str, transform_path: str,
                               device=torch.device("cuda"), negatives=None,
                               timings: dict | None = None):
    """Classify one FOV's 7-bit spectra with the reference's 4-pickle
    stack (UMAP, scaler, embedded SVC, check SVCs) on ``device`` and write
    the cell_information table: the float32 features with the predicted
    check bits, then the barcode, sample, label and shape columns.
    ``negatives`` and ``timings`` as in classify_ecoli_legacy."""
    device = torch.device(device)
    lap = stage_timer(timings, device)
    sample = input_spectra[: -len("_avgint_norm.csv")]
    avgint = _read_spectra_as_pandas(input_spectra, header=True)
    segmentation = np.load(sample + "_seg.npy")
    avgint_norm = _row_max_normalize(avgint)
    n = avgint_norm.shape[0]
    feats = np.concatenate(
        [avgint_norm, np.zeros((n, 4), np.float32)], axis=1)
    stack = umap_infer.load_legacy_umap_stack_7b(transform_path,
                                                 device=device)
    lap("load")
    codes, feats = stack.predict(feats, return_checks=True,
                                 negatives=negatives, timings=timings)
    lap = stage_timer(timings, device)
    codes = np.asarray(codes).astype(str)
    _write_cell_information(sample, feats, codes, segmentation, device)
    lap("write")
    return codes
