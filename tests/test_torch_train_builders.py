"""The port's classifier builders (hiprfish_tpu_torch/models/train.py)
against the JAX package's, on the 8-code reference folder of
tests/test_train_builders.py at 40 simulations per code and 60 training
steps: the same registry of reference builder names, and per builder the
same codebook, artifact file name and feature width as the JAX builder's,
and every measured code mean classified as its own code. This file runs
the 10-bit builders and the command line; tests/test_torch_train_builders_7b.py
the 7-bit and FRET ones."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import hiprfish_tpu.models.train as jtrain
from hiprfish_tpu.config import ClassifierConfig as JConfig
from hiprfish_tpu.config import TEN_BIT as JTEN
from hiprfish_tpu.utils import synthetic as jsyn
from hiprfish_tpu_torch.config import (ClassifierConfig, SEVEN_BIT, TEN_BIT,
                                       convert_code_to_7b)
from hiprfish_tpu_torch.models import classifier as tclf
from hiprfish_tpu_torch.models import train as ttrain
from hiprfish_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CODES = [5, 37, 515, 96, 640, 17, 260, 770]
SPC = 40
CFG = ClassifierConfig(check_train_steps=60)
JCFG = JConfig(check_train_steps=60)


def self_accuracy(clf, folder):
    """Share of the measured code means (row-max normalised) the port's
    classify calls as their own code: tests/test_train_builders.py's rule,
    over the codes the classifier knows (7-bit classifiers: the 10-bit
    codes with bit 6 clear, on channels 32-94, as their 7-bit codes)."""
    stats = ttrain.load_reference_stats(folder)
    seven = clf.layout_name == SEVEN_BIT.name
    encs, want = [], []
    for e in sorted(stats):
        code = TEN_BIT.code_str(e)
        if seven:
            if code[6] != "0":
                continue
            code = convert_code_to_7b(code)
        if code in clf.codebook:
            encs.append(e)
            want.append(code)
    means = np.stack([stats[e][0] for e in encs]).astype(np.float32)
    if seven:
        means = means[:, 32:95]
    means = means / np.maximum(means.max(axis=1, keepdims=True), 1e-12)
    codes, _, _, _ = tclf.classify(clf, means, device="cpu")
    return np.mean([c == w for c, w in zip(codes, want)])


def write_folder(path, encs=CODES, norm=True):
    """The 8-code folder of the JAX builder tests (30 cells per code,
    seed 0), with the *_avgint_norm.csv files the select variants glob."""
    tsyn.write_reference_folder(TEN_BIT, path, encs, cells_per_code=30,
                                seed=0)
    if norm:
        for f in glob.glob(os.path.join(path, "*_avgint.csv")):
            rows = np.loadtxt(f, delimiter=",", ndmin=2)
            rows = rows / np.maximum(rows.max(axis=1, keepdims=True), 1e-12)
            np.savetxt(f[: -len(".csv")] + "_norm.csv", rows, delimiter=",")


def run_both(base, tmp_path, name, args, port_args=None):
    """Run the registry's builder ``name`` of both packages on copies of
    ``base``; return (JAX classifier, port classifier, new files of each)."""
    out = []
    for pkg, sub, a in ((jtrain, "jax", args), (ttrain, "port",
                                                port_args or args)):
        folder = str(tmp_path / sub)
        shutil.copytree(base, folder)
        before = set(os.listdir(folder))
        kw = dict(cfg=JCFG if pkg is jtrain else CFG)
        if pkg is ttrain:
            kw["device"] = "cpu"
        clf = pkg.REFERENCE_BUILDERS[name](folder, *a, **kw)
        out.append((clf, sorted(set(os.listdir(folder)) - before), folder))
    return out


@pytest.fixture(scope="module")
def ref10(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref10") / "hiprfish_1023_reference")
    write_folder(path)
    return path


def taxon_tables(codes7):
    """A taxon table with a ``code`` column of 7-bit codes, as a DataFrame
    for the JAX package and as the port's pipeline/biofilm.TaxonLookup."""
    import pandas as pd

    from hiprfish_tpu_torch.pipeline.biofilm import TaxonLookup

    n = len(codes7)
    port = TaxonLookup(np.arange(n), np.array(codes7, dtype=object),
                       np.arange(n) / n, np.ones(n), np.ones(n))
    return pd.DataFrame({"code": codes7}), port


TENBIT = [
    "load_training_data_simulate_normalized",
    "load_training_data_simulate_normalized_umap_transformed",
    "load_training_data_simulate_normalized_differentiated_umap_transformed",
    "load_training_data_simulate",
    "load_training_data_simulate_normalized_custom_kernel",
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed",
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "violet_derivative_umap_transformed",
    "load_training_data_simulate_excitation_adjusted_normalized_noise_free_"
    "umap_transformed",
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "differentiated_umap_transformed",
]
MIX = [
    "load_training_data_simulate_normalized_select",
    "load_training_data_simulate_normalized_select_excitation_adjusted",
    "load_training_data_simulate_select",
]


def test_registry_names_equal_the_reference():
    assert list(ttrain.REFERENCE_BUILDERS) == list(jtrain.REFERENCE_BUILDERS)
    assert len(ttrain.REFERENCE_BUILDERS) == 25


def _check(out, n_codes=None):
    (cj, files_j, _), (ct, files_t, folder_t) = out
    assert ct.codebook == cj.codebook
    if n_codes is not None:
        assert len(ct.codebook) == n_codes
    assert files_t == files_j and len(files_t) <= 1
    assert ct.train_features.shape[1] == cj.train_features.shape[1]
    assert len(ct.check_params) == len(cj.check_params)
    assert self_accuracy(ct, folder_t) == 1.0


@pytest.mark.parametrize("name", TENBIT, ids=lambda n: n[len(
    "load_training_data"):])
def test_tenbit_builders_match_the_reference(ref10, tmp_path, name):
    _check(run_both(ref10, tmp_path, name, (SPC,)), len(CODES))


@pytest.mark.parametrize("name", MIX, ids=lambda n: n[len(
    "load_training_data_simulate"):])
def test_mix_table_builders_match_the_reference(ref10, tmp_path, name):
    tab = tmp_path / "mix_3_table.csv"
    with open(tab, "w") as f:
        f.write("Barcodes,Taxon\n")
        f.writelines(f"{c},t{c}\n" for c in CODES[:5])
    _check(run_both(ref10, tmp_path, name, (SPC, str(tab))), 5)


def test_taxon_select_builder_takes_the_ports_taxon_lookup(ref10, tmp_path):
    codes7 = [convert_code_to_7b(TEN_BIT.code_str(e)) for e in CODES[:4]]
    frame, lookup = taxon_tables(codes7)
    out = run_both(ref10, tmp_path, "load_training_data_simulate_normalized_"
                   "biofilm_select_umap_transformed", (SPC, frame),
                   (SPC, lookup))
    _check(out)


def test_direct_builder_and_cli_match_the_reference(tmp_path):
    # cli.train -v direct on a 3-code folder, as the JAX CLI test runs it:
    # the same file, and the same kNN matrix (no simulation)
    from hiprfish_tpu.cli import train as jcli
    from hiprfish_tpu_torch.cli import train as tcli
    from hiprfish_tpu_torch.models.artifacts import load_classifier

    folders = []
    for sub, cli, extra in (("jax", jcli, []),
                            ("port", tcli, ["--device", "cpu"])):
        folder = tmp_path / sub
        tsyn.write_reference_folder(TEN_BIT, str(folder), [5, 37, 515],
                                    cells_per_code=25, seed=0)
        before = set(os.listdir(folder))
        cli.main([str(folder), "-v", "direct", *extra])
        folders.append((folder, sorted(set(os.listdir(folder)) - before)))
    (fj, new_j), (ft, new_t) = folders
    assert new_j == new_t == ["reference_all.npz"]
    cj = load_classifier(str(fj / new_j[0]))
    ct = load_classifier(str(ft / new_t[0]))
    assert ct.train_features.tobytes() == cj.train_features.tobytes()
    assert ct.train_labels.tobytes() == cj.train_labels.tobytes()
    assert ct.codebook == cj.codebook
    assert self_accuracy(ct, str(ft)) == 1.0


def test_write_reference_folder_bytes_equal(tmp_path):
    for layout, jl, encs in ((TEN_BIT, JTEN, [5, 37, 1023]),):
        tsyn.write_reference_folder(layout, str(tmp_path / "t"), encs,
                                    cells_per_code=11, seed=4,
                                    write_norm=True)
        jsyn.write_reference_folder(jl, str(tmp_path / "j"), encs,
                                    cells_per_code=11, seed=4,
                                    write_norm=True)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


def test_mix_table_reader_equals_pandas(tmp_path):
    import pandas as pd

    from hiprfish_tpu_torch.io import tables

    tab = tmp_path / "mix_1.csv"
    tab.write_text("Taxon,Barcodes,Abundance\na,5,0.5\nb,0037,0.25\n"
                   "c,1023,\n")
    want = [int(b) for b in pd.read_csv(tab).Barcodes.values]
    assert tables.read_mix_barcodes(str(tab)) == want == [5, 37, 1023]
