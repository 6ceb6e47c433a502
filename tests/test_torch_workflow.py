"""Port parity for the workflow driver (hiprfish_tpu_torch/workflows/
driver.py, cli/workflow.py) and the table helpers it reads
(io/tables.py): the JAX cli.workflow and the port's (--device cpu), each
on its own copy of one data directory, write byte-identical per-FOV
artifacts and _results.csv; a second port run re-runs no stage.

- 10-bit, mode R and mode M: two 192^2 FOVs of tests/test_full_pipeline.py's
  recipe, the committed 1023-class fixture linked in under the ecoli
  classifier convention (SPC 200 in the table);
- 7-bit multispecies: one 192^2 FOV of tests/test_torch_cli.py's, the
  committed 127-code fixture linked in under the 7-bit convention.
"""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from hiprfish_tpu.io import tables as jtables
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.config import TEN_BIT as JTEN_BIT
from hiprfish_tpu_torch.io import tables
from hiprfish_tpu_torch.utils.logging import RunLog
from hiprfish_tpu_torch.workflows import driver

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CLF_10B = os.path.join(FIXTURES, "torch_port_clf_10b_1023x200.npz")
CLF_7B = os.path.join(FIXTURES, "torch_port_clf_7b_127x50.npz")
NAME_10B = ("reference_simulate_200_excitation_adjusted_normalized_"
            "violet_derivative_umap_transform.npz")
NAME_7B = ("reference_simulate_50_interaction_simulated_excitation_"
           "adjusted_normalized_umap_transform_biofilm_7b.npz")
ENCS = (5, 37)
CODES_7B = [1, 9, 65, 127, 34, 88]
MAX_CELLS = "64"

# ----------------------------------------------------------------- tables


def test_workflow_config(tmp_path):
    cfg = {
        "__default__": {"SCRIPTS_PATH": "/s", "DATA_DIR": "/d",
                        "PROBE_DESIGN_DIR": "/p"},
        "images": {"image_list_table": "/t.csv", "image_type": "M"},
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    got = tables.WorkflowConfig.from_json(str(p))
    want = jtables.WorkflowConfig.from_json(str(p))
    assert vars(got) == vars(want)
    assert got.data_dir == "/d" and got.image_type == "M"
    p.write_text(json.dumps({}))
    assert vars(tables.WorkflowConfig.from_json(str(p))) \
        == vars(jtables.WorkflowConfig.from_json(str(p)))


def test_name_helpers_equal_jax():
    for args in (("/d", "f", "s", [488, 514]), ("d", "ref", "x_1", ["405"])):
        assert tables.channel_image_filenames(*args) \
            == jtables.channel_image_filenames(*args)
    for spc in (2000, 120, 120.0):
        assert tables.reference_clf_path("/d", "ref", spc) \
            == jtables.reference_clf_path("/d", "ref", spc)


BASE_ROW = {"REFERENCE_FOLDER": "ref", "SPC": 500,
            "INPUT_TAB_FILENAME": "images_table_mix_7.csv"}
TREE = [
    # tests/test_io.py:85-120's walk of the whole convention tree
    {"REFERENCE_TYPE": "A"},
    {"REFERENCE_NORMALIZATION": "T", "REFERENCE_SCOPE": "Select"},
    {"REFERENCE_NORMALIZATION": "T", "REFERENCE_UMAP": "T"},
    {"REFERENCE_NORMALIZATION": "T", "REFERENCE_UMAP": "F"},
    {"REFERENCE_NORMALIZATION": "F", "REFERENCE_SCOPE": "Select"},
    {"REFERENCE_NORMALIZATION": "F"},
    # missing and NaN cells take the defaults
    {"REFERENCE_TYPE": np.nan, "REFERENCE_NORMALIZATION": np.nan},
    {"REFERENCE_FOLDER": np.nan, "SPC": np.nan, "REFERENCE_UMAP": None},
    {"SPC": 120.0, "REFERENCE_SCOPE": "All"},
]


@pytest.mark.parametrize("overrides", TREE)
def test_reference_clf_path_from_row_tree(overrides):
    row = dict(BASE_ROW, **overrides)
    got = tables.reference_clf_path_from_row("/d", row)
    assert got == jtables.reference_clf_path_from_row("/d", row)
    assert got == jtables.reference_clf_path_from_row("/d", pd.Series(row))


def test_reference_clf_path_from_row_defaults_and_errors():
    row = {"REFERENCE_FOLDER": "ref", "SPC": 2000}
    assert tables.reference_clf_path_from_row("/d", row) \
        == tables.reference_clf_path("/d", "ref", 2000)
    bad = dict(BASE_ROW, REFERENCE_SCOPE="Select",
               INPUT_TAB_FILENAME="images_table.csv")
    for mod in (tables, jtables):
        with pytest.raises(ValueError):
            mod.reference_clf_path_from_row("/d", bad)


def _dispatch_table(path):
    """A table pandas wrote with empty cells and NA tokens in the
    dispatch columns, an int SPC column and one with an empty field."""
    path.write_text(
        "SAMPLE,IMAGES,REFERENCE_FOLDER,SPC,SPC_GAP,REFERENCE_TYPE,"
        "REFERENCE_NORMALIZATION,REFERENCE_SCOPE,REFERENCE_UMAP,"
        "INPUT_TAB_FILENAME,FLAG\n"
        "s,a_enc_5,ref,120,120,,T,All,,images_table_mix_2.csv,True\n"
        "s,a_enc_6,ref,200,,S,NA,Select,F,images_table_mix_3.csv,False\n"
        "s,a_enc_7,,300,300,A,F,,None,x.csv,true\n"
        "s,a_enc_8,ref2,400,400,null,F,Select,T,mix_9.csv,FALSE\n")


def test_read_image_table_types_as_pandas(tmp_path):
    path = tmp_path / "t.csv"
    _dispatch_table(path)
    got = tables.read_image_table(str(path))
    want = pd.read_csv(path)
    assert list(got) == list(want.columns)
    for name in want.columns:
        col = want[name].to_numpy()
        assert got[name].dtype == col.dtype, name
        if col.dtype == object:
            assert [None if tables.is_na(v) else v for v in got[name]] \
                == [None if pd.isna(v) else v for v in col], name
        else:
            np.testing.assert_array_equal(got[name], col)
    for i in range(len(want)):
        assert tables.reference_clf_path_from_row(
            "/d", tables.table_row(got, i)) \
            == jtables.reference_clf_path_from_row("/d", want.loc[i])
    gap = dict(tables.table_row(got, 0), SPC=got["SPC_GAP"][0])
    assert "reference_simulate_120.0_" in \
        tables.reference_clf_path_from_row("/d", gap)


# --------------------------------------------------------------- workflows


def _write_planes(folder, layout, fov, sample):
    for laser, plane in zip(layout.lasers, fov["stack"]):
        np.save(folder / f"{sample}_{laser}.npy", plane)


def _experiment(root, family, mode="R"):
    """A data directory with its FOVs' planes and the linked classifier,
    the experiment table and the config. Returns (config, table, fovs
    folder, samples)."""
    data_dir = root / "data"
    folder = data_dir / "fovs"
    ref = data_dir / "ref"
    folder.mkdir(parents=True)
    ref.mkdir()
    rows = []
    if family == "ecoli":
        os.symlink(CLF_10B, ref / NAME_10B)
        samples = [f"run_enc_{e}" if mode == "R" else f"run_mix_0_fov_{k + 1}"
                   for k, e in enumerate(ENCS)]
        for enc, sample in zip(ENCS, samples):
            fov = jsynthetic.make_fov(
                JTEN_BIT, [enc] * 6 if mode == "R" else [enc, 515, 96] * 2,
                shape=(192, 192), seed=enc,
                laser_shifts=[(0, 0), (1, -1), (0, 1), (-1, 0), (1, 1)],
                cell_axes=(9.0, 14.0))
            _write_planes(folder, JTEN_BIT, fov, sample)
            rows.append({"SAMPLE": "fovs", "IMAGES": sample,
                         "CALIBRATION": "F", "CALIBRATION_FILENAME": "none",
                         "REFERENCE_FOLDER": "ref", "SPC": 200})
    else:
        os.symlink(CLF_7B, ref / NAME_7B)
        samples = ["community_A_564_fov_1"]
        fov = jsynthetic.make_fov(JSEVEN_BIT, CODES_7B, shape=(192, 192),
                                  seed=5, cell_axes=(7.0, 12.0))
        _write_planes(folder, JSEVEN_BIT, fov, samples[0])
        rows.append({"SAMPLE": "fovs", "IMAGES": samples[0],
                     "CALIBRATION": "F", "CALIBRATION_FILENAME": "none",
                     "REFERENCE_FOLDER": "ref", "SPC": 50})
    table = root / ("images_table.csv" if mode == "R"
                    else "images_table_mix_0.csv")
    pd.DataFrame(rows).to_csv(table, index=False)
    config = root / "hiprfish_config_imaging.json"
    config.write_text(json.dumps({
        "__default__": {"SCRIPTS_PATH": "", "DATA_DIR": str(data_dir)},
        "images": {"image_list_table": str(table), "image_type": mode},
    }))
    return config, table, folder, samples


def _run_both(root, family, mode="R"):
    """The same experiment in two directories, through the JAX CLI and
    the port's. Returns {side: (table, folder, samples, RunLog)}."""
    from hiprfish_tpu.cli import workflow as jcli
    from hiprfish_tpu_torch.cli import workflow as cli

    out = {}
    for side in ("port", "jax"):
        config, table, folder, samples = _experiment(root / side, family,
                                                     mode)
        flags = [str(config), "--family", family, "--max_cells", MAX_CELLS]
        log = (cli.main([*flags, "--device", "cpu"]) if side == "port"
               else jcli.main(flags))
        out[side] = (table, folder, samples, log)
    return out


def _same_bytes(a, b):
    """Equal bytes once each copy's own directory is named alike (the
    classifiers write the sample's path into _avgint_ids.csv and
    _cell_information.csv)."""
    root_a, root_b = (str(p).split("/data/")[0].encode() for p in (a, b))
    assert a.read_bytes().replace(root_a, b"ROOT") \
        == b.read_bytes().replace(root_b, b"ROOT"), (a, b)


def _second_run_reruns_nothing(table, folder, samples, family, suffixes):
    from hiprfish_tpu_torch.cli import workflow as cli

    config = table.parent / "hiprfish_config_imaging.json"
    artifacts = [folder / f"{s}{x}" for s in samples for x in suffixes]
    mtimes = {a: os.path.getmtime(a) for a in artifacts}
    log = cli.main([str(config), "--family", family, "--max_cells",
                    MAX_CELLS, "--device", "cpu"])
    for a in artifacts:
        assert os.path.getmtime(a) == mtimes[a], a
    stages = {e["stage"] for e in log.events}
    assert not stages & {"measure", "classify"}, stages


ECOLI_ARTIFACTS = ("_avgint.csv", "_avgint_norm.csv", "_seg.npy",
                   "_cell_ids.txt", "_avgint_ids.csv")


@pytest.mark.parametrize("mode", ["R", "M"])
def test_ecoli_workflow_equals_jax(tmp_path, mode):
    runs = _run_both(tmp_path, "ecoli", mode)
    table, folder, samples, log = runs["port"]
    jtable, jfolder, _, _ = runs["jax"]
    for s in samples:
        seg = np.load(folder / f"{s}_seg.npy")
        np.testing.assert_array_equal(seg, np.load(jfolder / f"{s}_seg.npy"))
        assert seg.max() == 6
        for suffix in ("_avgint.csv", "_avgint_norm.csv", "_cell_ids.txt",
                       "_avgint_ids.csv"):
            _same_bytes(folder / f"{s}{suffix}", jfolder / f"{s}{suffix}")
    results = str(table)[:-len(".csv")] + "_results.csv"
    names = [os.path.basename(results)]
    if mode == "M":
        names.append(names[0][:-len(".csv")] + "_abundance.csv")
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes(), name
    res = pd.read_csv(results)
    assert (res.NCells.values == 6).all()
    if mode == "R":
        assert (res.ErrorRate.values <= 1 / 6 + 1e-9).all()
    summary = log.summary()
    assert summary["measure"]["count"] == summary["classify"]["count"] == 2
    assert summary["collect"]["count"] == 1
    _second_run_reruns_nothing(table, folder, samples, "ecoli",
                               ECOLI_ARTIFACTS)


def test_multispecies_workflow_equals_jax(tmp_path):
    runs = _run_both(tmp_path, "multispecies")
    table, folder, samples, log = runs["port"]
    _, jfolder, _, _ = runs["jax"]
    s = samples[0]
    np.testing.assert_array_equal(np.load(folder / f"{s}_seg.npy"),
                                  np.load(jfolder / f"{s}_seg.npy"))
    for suffix in ("_avgint_norm.csv", "_cell_information.csv"):
        _same_bytes(folder / f"{s}{suffix}", jfolder / f"{s}{suffix}")
    rows = (folder / f"{s}_cell_information.csv").read_text().splitlines()
    assert sorted(r.split(",")[67] for r in rows) \
        == sorted(JSEVEN_BIT.code_str(c) for c in CODES_7B)
    assert log.summary()["classify"]["count"] == 1
    _second_run_reruns_nothing(table, folder, samples, "multispecies",
                               ("_avgint_norm.csv", "_seg.npy",
                                "_registered.npy", "_cell_information.csv"))


def test_workflow_defaults_to_cuda(tmp_path):
    """Without a card, cli.workflow raises unless --device cpu is given."""
    from hiprfish_tpu_torch.cli import workflow as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config, _, _, _ = _experiment(tmp_path, "ecoli")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([str(config)])


def test_czi_and_stage_failures_raise(tmp_path):
    """A .czi plane raises NotImplementedError naming the readers' item;
    a missing classifier raises FileNotFoundError: no stage failure is
    caught to carry on with the next FOV."""
    config, table, folder, samples = _experiment(tmp_path, "ecoli")
    czi = folder / f"{samples[0]}_405.czi"
    czi.write_bytes(b"ZISRAWFILE")
    log = RunLog(stream=open(os.devnull, "w"))
    with pytest.raises(NotImplementedError, match="A.7"):
        driver.run_ecoli_workflow(str(config), log, 64, "cpu")
    log.stream.close()
    czi.unlink()
    os.unlink(tmp_path / "data" / "ref" / NAME_10B)
    with pytest.raises(FileNotFoundError):
        driver.run_ecoli_workflow(str(config), RunLog(stream=open(
            os.devnull, "w")), 64, "cpu")
    assert not os.path.exists(folder / f"{samples[1]}_avgint.csv")
    assert not os.path.exists(str(table)[:-len(".csv")] + "_results.csv")


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from hiprfish_tpu_torch.utils.logging import profile_trace

    with profile_trace(str(tmp_path / "trace"), "cpu"):
        torch.ones(8, 8).sum()
    trace = tmp_path / "trace" / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]
    shutil.rmtree(tmp_path / "trace")
