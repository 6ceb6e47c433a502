"""The port's whole loop on the CPU, the counterpart of
tests/test_full_pipeline.py::test_ecoli_reference_pipeline_end_to_end at
its sizes and with its assertions: synthetic measured reference spectra ->
the port's trainer -> one synthetic FOV per barcode as .npy planes -> the
port's measure and classify command lines -> the port's collect ->
known-barcode error rates."""

import os

import numpy as np
import torch

from hiprfish_tpu_torch.cli import classify as cli_classify
from hiprfish_tpu_torch.cli import measure as cli_measure
from hiprfish_tpu_torch.config import TEN_BIT, ClassifierConfig
from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.models import train as mtrain
from hiprfish_tpu_torch.pipeline import collect
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CODES = [5, 37, 515, 96, 640, 17, 260, 770, 1023]


def test_ecoli_reference_pipeline_end_to_end(tmp_path, monkeypatch):
    data_dir = tmp_path / "data"
    ref_folder = data_dir / "hiprfish_1023_reference_08_18_2018"
    ref_folder.mkdir(parents=True)

    # 1) synthetic measured reference spectra + classifier training
    synthetic.write_reference_folder(TEN_BIT, str(ref_folder), CODES,
                                     cells_per_code=40, seed=0)
    cfg = ClassifierConfig(simulations_per_code=150, check_train_steps=300)
    mtrain.train_excitation_adjusted_violet_derivative(
        str(ref_folder), 150, cfg, save=True, device="cpu")
    clf_path = os.path.join(
        str(ref_folder),
        "reference_simulate_150_excitation_adjusted_normalized_"
        "violet_derivative_umap_transform.npz")
    assert os.path.exists(clf_path)

    # 2) one synthetic FOV per barcode, written as per-laser .npy planes
    folder = data_dir / "08_18_2018_1023_reference"
    folder.mkdir()
    rows = []
    for enc in CODES[:3]:
        image_name = f"08_18_2018_enc_{enc}"
        fov = synthetic.make_fov(
            TEN_BIT, [enc] * 6, shape=(192, 192), seed=enc,
            laser_shifts=[(0, 0), (1, -1), (0, 1), (-1, 0), (1, 1)],
            cell_axes=(9.0, 14.0))
        for laser, plane in zip(TEN_BIT.lasers, fov["stack"]):
            np.save(folder / f"{image_name}_{laser}.npy", plane)
        rows.append([folder.name, image_name, "F", "none", ref_folder.name])
    table_path = tmp_path / "images_table.csv"
    outputs.write_csv(str(table_path), np.array(rows), header=[
        "SAMPLE", "IMAGES", "CALIBRATION", "CALIBRATION_FILENAME",
        "REFERENCE_FOLDER"])

    # 3) measure + classify through the command lines
    monkeypatch.chdir(folder)
    for r in rows:
        image_files = [f"{r[1]}_{laser}.npy" for laser in TEN_BIT.lasers]
        cli_measure.main(["-i", *image_files, "-c", "F", "--max_cells", "64",
                          "--device", "cpu"])
        assert os.path.exists(f"{r[1]}_avgint.csv")
        cli_classify.main([f"{r[1]}_avgint.csv", "-rf", clf_path,
                           "--device", "cpu"])
        assert os.path.exists(f"{r[1]}_cell_ids.txt")

    # 4) collect: per-sample error rates against the known barcode
    monkeypatch.chdir(tmp_path)
    out_csv = tmp_path / "images_table_results.csv"
    res = collect.collect_reference_measurement_results(
        str(data_dir), str(table_path), str(out_csv))
    assert os.path.exists(out_csv)
    assert (res["NCells"] >= 5).all()
    # every FOV classifies with <= 1 wrong cell
    assert (res["ErrorRate"] <= 1 / 5 + 1e-9).all()
    # a sample with zero errors takes the upper-limit convention
    assert set(res["ErrorRateUpperLimit"]) <= {"T", "F"}
    assert {"OneBitError", "TwoBitError", "MultipleBitError"} <= set(res)
