"""The port's 7-bit and FRET classifier builders against the JAX
package's (see tests/test_torch_train_builders.py for the 10-bit ones and
the rule): per builder the same codebook, artifact file name and feature
width, and every measured code mean the classifier knows called as its own
code; for the fixed-distance FRET variants, whose spectra take no
jax.random draw, also the training arrays and the kNN matrix themselves
within float32 rounding.

The FRET family simulates each code from the seven single-fluorophore
spectra, not from the code's own measured spectrum, and the JAX builders
call only 0.53-0.87 of the 15 measured code means of this folder right
(seeds 0-2); the port's must reach 0.5."""

import numpy as np
import pytest
import torch

import hiprfish_tpu.models.train as jtrain
from hiprfish_tpu_torch.config import TEN_BIT, convert_code_to_7b
from hiprfish_tpu_torch.models import train as ttrain
from hiprfish_tpu_torch.utils import synthetic as tsyn
from tests.test_torch_train_builders import (CODES, SPC, run_both,
                                             self_accuracy, taxon_tables,
                                             write_folder)

torch.set_num_threads(1)

# the 7 single-fluorophore barcodes the FRET builders read
ONE_HOT = [512, 128, 64, 32, 4, 2, 1]
# CODES whose 10-bit code keeps bits 1, 5 and 6 clear: the biofilm sets
OK7 = [e for e in CODES if TEN_BIT.code_str(e)[6] == "0"
       and TEN_BIT.code_str(e)[5] == "0" and TEN_BIT.code_str(e)[1] == "0"]
FRET_SPC = 30


@pytest.fixture(scope="module")
def ref10(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref10") / "hiprfish_1023_reference")
    write_folder(path, norm=False)
    return path


@pytest.fixture(scope="module")
def ref_fret(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reffret") / "reference")
    write_folder(path, norm=False)
    tsyn.write_reference_folder(TEN_BIT, path, ONE_HOT, cells_per_code=30,
                                seed=3)
    return path


def _probe_design(tmp_path, codes7):
    path = tmp_path / "probes.csv"
    path.write_text("target_taxon,code\n" + "".join(
        f"{100 + i},{c}\n" for i, c in enumerate(codes7)))
    return str(path)


def _check(out, codebook=None):
    (cj, files_j, _), (ct, files_t, folder_t) = out
    assert ct.codebook == cj.codebook
    if codebook is not None:
        assert set(ct.codebook) == set(codebook)
    assert files_t == files_j and len(files_t) == 1
    assert ct.train_features.shape[1] == cj.train_features.shape[1]
    assert len(ct.check_params) == len(cj.check_params)
    assert (ct.scaler_mean is None) == (cj.scaler_mean is None)
    return self_accuracy(ct, folder_t)


BIOFILM = [
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_biofilm_7b",
    "load_training_data_simulate_excitation_adjusted_normalized_scaled_"
    "umap_transformed_biofilm_7b",
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_error_threshold_biofilm_7b",
]


@pytest.mark.parametrize("name", BIOFILM, ids=["biofilm_7b", "scaled",
                                               "error_threshold"])
def test_biofilm_builders_match_the_reference(ref10, tmp_path, name):
    want = {convert_code_to_7b(TEN_BIT.code_str(e)) for e in OK7}
    assert _check(run_both(ref10, tmp_path, name, (SPC,)), want) == 1.0


@pytest.mark.parametrize("name", [
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_error_threshold_biofilm_7b_limited",
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_biofilm_7b_limited",
], ids=["error_threshold_limited", "limited"])
def test_taxon_limited_builders_match_the_reference(ref10, tmp_path, name):
    subset = sorted({convert_code_to_7b(TEN_BIT.code_str(e))
                     for e in OK7[:2]})
    frame, lookup = taxon_tables(subset)
    out = run_both(ref10, tmp_path, name, (SPC, frame), (SPC, lookup))
    assert _check(out, subset) == 1.0


def test_probe_design_builder_matches_the_reference(ref10, tmp_path):
    subset = sorted({convert_code_to_7b(TEN_BIT.code_str(e))
                     for e in OK7[:3]})
    out = run_both(ref10, tmp_path, "load_training_data_simulate_excitation_"
                   "adjusted_normalized_umap_transformed_biofilm_7b_DSGN",
                   (SPC, _probe_design(tmp_path, subset)))
    assert _check(out, subset) == 1.0


FRET = {
    "reabsorption": ("load_training_data_simulate_reabsorption_"
                     "umap_transformed_biofilm_7b", ()),
    "reabsorption_limited": ("load_training_data_simulate_reabsorption_"
                             "umap_transformed_limited_biofilm_7b", "subset"),
    "reabsorption_excitation_adjusted": (
        "load_training_data_simulate_reabsorption_excitation_adjusted_"
        "umap_transformed_biofilm_7b", ()),
    "fret": ("load_training_data_simulate_reabsorption_excitation_adjusted_"
             "umap_transformed_with_fret_biofilm_7b", ()),
    "fret_limited": ("load_training_data_simulate_reabsorption_excitation_"
                     "adjusted_umap_transformed_with_fret_biofilm_7b_limited",
                     "probes"),
}


@pytest.mark.parametrize("case", list(FRET))
def test_fret_builders_match_the_reference(ref_fret, tmp_path, case,
                                           monkeypatch):
    name, extra = FRET[case]
    subset = sorted({convert_code_to_7b(TEN_BIT.code_str(e)) for e in OK7})
    args = (None, FRET_SPC)
    if extra == "subset":
        args += (set(subset),)
    elif extra == "probes":
        args += (_probe_design(tmp_path, subset),)
    seen = {}

    def recorder(tag, fn):
        def wrapped(gen, layout, spectra, codes, checks, cfg, **kw):
            seen[tag] = (spectra, codes, checks, kw.get("check_spectra"))
            return fn(gen, layout, spectra, codes, checks, cfg, **kw)
        return wrapped

    monkeypatch.setattr(jtrain, "train_classifier",
                        recorder("jax", jtrain.train_classifier))
    monkeypatch.setattr(ttrain, "train_classifier",
                        recorder("port", ttrain.train_classifier))
    out = run_both(ref_fret, tmp_path, name, args)
    acc = _check(out, subset if extra else None)
    (sj, cj, kj, nj), (st, ct, kt, nt) = seen["jax"], seen["port"]
    assert ct == cj
    np.testing.assert_array_equal(kt, kj)
    assert (nt is None) == (nj is None)
    assert acc >= 0.5
    if "fret" in case:
        # the FRET distance is drawn per row; the arrays differ
        return
    # fixed distance: RandomState draws only, the same arrays
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    (clf_j, _, _), (clf_t, _, _) = out
    np.testing.assert_allclose(clf_t.train_features, clf_j.train_features,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(clf_t.train_labels, clf_j.train_labels)


def test_fixed_distance_fret_with_negatives_matches_the_reference(
        ref_fret, monkeypatch):
    seen = {}
    for tag, mod in (("jax", jtrain), ("port", ttrain)):
        def stop(gen, layout, spectra, codes, checks, cfg, _tag=tag, **kw):
            seen[_tag] = (spectra, kw["check_spectra"],
                          kw["check_bits_full"])
            raise StopIteration
        monkeypatch.setattr(mod, "train_classifier", stop)
        kw = {"device": "cpu"} if mod is ttrain else {}
        with pytest.raises(StopIteration):
            mod.train_fret_biofilm_7b(ref_fret, spc=FRET_SPC, save=False,
                                      fret_distance=5.0, **kw)
    (pj, nj, bj), (pt, nt, bt) = seen["jax"], seen["port"]
    assert nt.shape == nj.shape == (2 * 127 * FRET_SPC, 63)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(bt, bj)
