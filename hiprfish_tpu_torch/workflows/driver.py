"""Workflow driver (the port of hiprfish_tpu/workflows/driver.py): the
in-process replacement for the reference's Snakemake DAGs.

Same external interface: a JSON config (hiprfish_config_imaging.json keys)
and an experiment CSV table drive measure -> classify per FOV, then one
collect (ecoli family); a stage is skipped when its outputs exist and are
no older than its inputs (Snakemake's recovery rule). The stages run in
one process, so the kernels and each classifier are loaded once, with
per-stage timing in a RunLog. A stage that fails raises: no FOV is
skipped on an error. The measure CLIs write into the current directory,
so the measure stage runs in the FOV's folder.

The measure and classify stages run on ``device`` (cuda by default; a
.czi input raises NotImplementedError, see io/images.py).
"""

from __future__ import annotations

import contextlib
import os

import torch

from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
from hiprfish_tpu_torch.io import tables
from hiprfish_tpu_torch.utils.logging import RunLog


def _outputs_fresh(outputs, inputs) -> bool:
    if not all(os.path.exists(o) for o in outputs):
        return False
    out_mtime = min(os.path.getmtime(o) for o in outputs)
    in_mtime = max(
        (os.path.getmtime(i) for i in inputs if os.path.exists(i)),
        default=0.0)
    return out_mtime >= in_mtime


def _find_channel_files(data_dir, folder, sample, lasers):
    files = []
    for laser in lasers:
        base = os.path.join(data_dir, folder, f"{sample}_{laser}")
        for ext in (".czi", ".npy", ".tif"):
            if os.path.exists(base + ext):
                files.append(base + ext)
                break
        else:
            raise FileNotFoundError(base + ".(czi|npy|tif)")
    return files


def run_ecoli_workflow(config_path: str, log: RunLog | None = None,
                       max_cells: int = 4096,
                       device=torch.device("cuda")) -> str:
    """The 3-rule ecoli DAG: per-FOV measure + classify, then one collect.
    Returns the results CSV path."""
    from hiprfish_tpu_torch.cli import measure as cli_measure
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import classify as pclassify
    from hiprfish_tpu_torch.pipeline import collect as pcollect

    device = torch.device(device)
    log = log or RunLog()
    cfg = tables.WorkflowConfig.from_json(config_path)
    tab = tables.read_image_table(cfg.image_list_table)

    clf_cache = {}
    for i in range(tables.n_rows(tab)):
        row = tables.table_row(tab, i)
        folder, sample = row["SAMPLE"], row["IMAGES"]
        workdir = os.path.join(cfg.data_dir, folder)
        prefix = os.path.join(workdir, sample)
        channel_files = _find_channel_files(cfg.data_dir, folder, sample,
                                            TEN_BIT.lasers)

        meas_outputs = [prefix + s for s in
                        ("_avgint.csv", "_avgint_norm.csv", "_seg.npy")]
        if not _outputs_fresh(meas_outputs, channel_files):
            with (log.stage("measure", sample=sample),
                  contextlib.chdir(workdir)):
                cal = str(row["CALIBRATION"])
                cal_file = os.path.join(
                    cfg.data_dir, str(row["CALIBRATION_FILENAME"]))
                cli_measure.measure_reference_images(
                    [os.path.basename(f) for f in channel_files],
                    cal if cal in ("T", "F") else "F",
                    cal_file, max_cells=max_cells, device=device)

        clf_outputs = [prefix + "_cell_ids.txt", prefix + "_avgint_ids.csv"]
        if not _outputs_fresh(clf_outputs, [prefix + "_avgint.csv"]):
            ref_clf = tables.reference_clf_path_from_row(cfg.data_dir, row)
            npz = ref_clf[:-len(".pkl")] + ".npz"
            if npz not in clf_cache:
                clf_cache[npz] = load_classifier(npz)
            with log.stage("classify", sample=sample):
                pclassify.classify_ecoli(prefix + "_avgint.csv",
                                         clf_cache[npz], device)

    output_filename = cfg.image_list_table.replace(".csv", "_results.csv")
    with log.stage("collect"):
        if cfg.image_type == "R":
            pcollect.collect_reference_measurement_results(
                cfg.data_dir, cfg.image_list_table, output_filename)
        else:
            pcollect.collect_mix_measurement_results(
                cfg.data_dir, cfg.image_list_table, output_filename)
    log.event("summary", **log.summary())
    return output_filename


def run_multispecies_workflow(config_path: str, log: RunLog | None = None,
                              max_cells: int = 4096,
                              device=torch.device("cuda")) -> None:
    """The synthetic-community DAG: LP-CV measure + 7-bit classify per
    FOV."""
    from hiprfish_tpu_torch.cli import measure_multispecies as cli_meas
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import classify as pclassify

    device = torch.device(device)
    log = log or RunLog()
    cfg = tables.WorkflowConfig.from_json(config_path)
    tab = tables.read_image_table(cfg.image_list_table)

    clf_cache = {}
    for i in range(tables.n_rows(tab)):
        row = tables.table_row(tab, i)
        folder, sample = row["SAMPLE"], row["IMAGES"]
        workdir = os.path.join(cfg.data_dir, folder)
        prefix = os.path.join(workdir, sample)
        channel_files = _find_channel_files(cfg.data_dir, folder, sample,
                                            SEVEN_BIT.lasers)
        if not _outputs_fresh([prefix + "_avgint_norm.csv",
                               prefix + "_seg.npy"], channel_files):
            with (log.stage("measure", sample=sample),
                  contextlib.chdir(workdir)):
                cal_path = os.path.join(
                    cfg.data_dir, str(row["CALIBRATION_FILENAME"]))
                cli_meas.measure_biofilm_images_no_reference(
                    [os.path.basename(f) for f in channel_files],
                    cal_path if os.path.exists(cal_path) else "",
                    max_cells=max_cells, device=device)
        if not _outputs_fresh([prefix + "_cell_information.csv"],
                              [prefix + "_avgint_norm.csv"]):
            spc = row["SPC"] if "SPC" in row else 2000
            npz = os.path.join(
                cfg.data_dir, str(row["REFERENCE_FOLDER"]),
                f"reference_simulate_{spc}_interaction_simulated_excitation_"
                "adjusted_normalized_umap_transform_biofilm_7b.npz")
            if npz not in clf_cache:
                clf_cache[npz] = load_classifier(npz)
            with log.stage("classify", sample=sample):
                pclassify.classify_spectra_7b(prefix + "_avgint_norm.csv",
                                              clf_cache[npz], device)
    log.event("summary", **log.summary())
