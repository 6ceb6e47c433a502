"""The port's train_classifier against the JAX package's on the same
spectra, with the JAX trainer's own initial parameters and permutations
passed in: train_features and train_labels byte for byte (scaler,
prototypes, raw-row subsets, full derivative), the check heads within the
tolerance of tests/test_torch_train_heads.py, and the same barcode calls
from both packages' classify on held-out simulated rows. Also the artifact
round trip across the packages and the codebook's kNN matrix of the
committed classifier fixtures."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import ClassifierConfig as JConfig
from hiprfish_tpu.config import SEVEN_BIT as JSEVEN, TEN_BIT as JTEN
from hiprfish_tpu.models import artifacts as jart
from hiprfish_tpu.models import classifier as jclf
from hiprfish_tpu_torch.config import ClassifierConfig, SEVEN_BIT, TEN_BIT
from hiprfish_tpu_torch.models import artifacts as tart
from hiprfish_tpu_torch.models import classifier as tclf
from hiprfish_tpu_torch.models import metrics as tmetrics
from hiprfish_tpu_torch.models import train as ttrain
from hiprfish_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
STEPS = 60
# (layout, codes) of the small training sets: 20 7-bit codes, 12 10-bit
CODES_7B = [1 + (i * 13) % 127 for i in range(20)]
CODES_10B = [5, 37, 515, 96, 640, 17, 260, 770, 1023, 3, 200, 900]


def _rows(layout, codes, spc, seed):
    """Noisy row-max-normalised spectra of ``codes``, ``spc`` rows each,
    and their barcode strings."""
    rng = np.random.RandomState(seed)
    lut = tsyn.fluorophore_spectra(layout)
    rows, strs = [], []
    for c in codes:
        spec = tsyn.barcode_spectrum(layout, c, lut)
        r = rng.uniform(0.7, 1.3, (spc, 1)) * spec[None, :] \
            + rng.randn(spc, layout.n_channels) * 0.02
        rows.append(np.clip(r, 0, None))
        strs += [layout.code_str(c)] * spc
    x = np.concatenate(rows).astype(np.float32)
    return x / np.maximum(x.max(axis=1, keepdims=True), 1e-12), strs


def _reference_head_draws(key, n_heads, wmax, n):
    """The initial parameters and permutations the JAX train_classifier
    draws from ``key``."""
    keys = jax.random.split(key, n_heads + 1)
    inits = [jclf._init_mlp(keys[b], wmax, 64) for b in range(n_heads)]
    stacked = {k: np.stack([np.asarray(i[k]) for i in inits])
               for k in inits[0]}
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(keys[-1], n_heads)])
    return stacked, perms


CASES = {
    "prototypes-default": dict(),
    "scaler-negatives": dict(scaler=True, negatives=True),
    "knn_store_per_class": dict(knn_store_per_class=7),
    "prototypes-3": dict(knn_prototypes_per_class=3,
                         knn_store_per_class=7),
    "full_derivative": dict(full_derivative=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_classifier_matches_the_reference(case):
    kw = dict(CASES[case])
    ten = kw.get("full_derivative", False)
    layout, jlayout = (TEN_BIT, JTEN) if ten else (SEVEN_BIT, JSEVEN)
    codes = CODES_10B if ten else CODES_7B
    spectra, strs = _rows(layout, codes, 30, seed=0)
    held, held_strs = _rows(layout, codes, 5, seed=1)
    if ten:
        spectra = np.concatenate([spectra, np.diff(spectra, axis=1)], 1)
        held = np.concatenate([held, np.diff(held, axis=1)], 1)
    checks = ttrain.check_bits_for_codes(layout, strs)
    if kw.pop("negatives", False):
        neg = spectra * np.random.RandomState(2).uniform(
            0, 0.4, (len(spectra), 1)).astype(np.float32)
        kw["check_spectra"] = np.concatenate([spectra, neg])
        kw["check_bits_full"] = np.concatenate([checks,
                                                np.zeros_like(checks)])
    key = jax.random.PRNGKey(3)
    want = jclf.train_classifier(key, jlayout, spectra, strs, checks,
                                 JConfig(check_train_steps=STEPS), **kw)

    n_heads = len(want.check_params)
    wmax = max(hi - lo for lo, hi in want.check_blocks)
    n = len(kw.get("check_spectra", spectra))
    draws = _reference_head_draws(key, n_heads, wmax, n)
    got = tclf.train_classifier(
        torch.Generator(), layout, spectra, strs, checks,
        ClassifierConfig(check_train_steps=STEPS), device="cpu",
        head_draws=draws, **kw)

    assert got.train_features.dtype == want.train_features.dtype
    assert got.train_features.tobytes() == want.train_features.tobytes()
    assert got.train_labels.tobytes() == want.train_labels.tobytes()
    for f in ("layout_name", "n_channels", "blocks", "check_slice",
              "codebook", "check_blocks", "n_neighbors", "temperature",
              "violet_derivative", "full_derivative"):
        assert getattr(got, f) == getattr(want, f), f
    if kw.get("scaler"):
        np.testing.assert_array_equal(got.scaler_mean, want.scaler_mean)
        np.testing.assert_array_equal(got.scaler_scale, want.scaler_scale)
    else:
        assert got.scaler_mean is None and want.scaler_mean is None
    for pg, pw in zip(got.check_params, want.check_params):
        for k in ("w1", "b1", "w2", "b2"):
            assert pg[k].shape == np.asarray(pw[k]).shape
            np.testing.assert_allclose(pg[k], np.asarray(pw[k]), rtol=0,
                                       atol=2e-3, err_msg=k)
    codes_t, _, _, feats_t = tclf.classify(got, held, device="cpu")
    codes_j, _, _, feats_j = want.classify(jnp.asarray(held))
    check_cols = slice(want.check_slice[0], want.check_slice[1])
    np.testing.assert_array_equal(feats_t[:, check_cols],
                                  feats_j[:, check_cols])
    assert codes_t == list(codes_j)
    assert np.mean([c == s for c, s in zip(codes_t, held_strs)]) >= 0.95


def test_metric_for_layout_equals_the_reference():
    from hiprfish_tpu.models import metrics as jmetrics

    for layout, jlayout in ((SEVEN_BIT, JSEVEN), (TEN_BIT, JTEN)):
        for violet in (False, True):
            assert tmetrics.metric_for_layout(layout, violet) == \
                jmetrics.metric_for_layout(jlayout, violet)


@pytest.mark.parametrize("fixture,layout,spc", [
    ("torch_port_clf_7b_127x50.npz", SEVEN_BIT, 50),
    ("torch_port_clf_10b_1023x200.npz", TEN_BIT, 200),
], ids=["7b", "10b"])
def test_fixture_recipes_give_the_fixtures_knn_matrices(fixture, layout,
                                                        spc):
    # the committed fixtures' training rows, rebuilt by the port from
    # RandomState(0), give their kNN matrices byte for byte
    fix = tart.load_classifier(os.path.join(FIXTURES, fixture))
    spectra, strs = tsyn.fixture_training_set(layout, spc)
    checks = ttrain.check_bits_for_codes(layout, strs)
    codebook, feats, labels = tclf.knn_reference(
        np.asarray(spectra, np.float32), strs, checks,
        fix.check_slice[1] - fix.check_slice[0])
    assert tuple(codebook) == fix.codebook
    assert feats.tobytes() == fix.train_features.tobytes()
    assert labels.tobytes() == fix.train_labels.tobytes()


def test_artifact_round_trip_across_the_packages(tmp_path):
    layout = SEVEN_BIT
    spectra, strs = _rows(layout, CODES_7B, 20, seed=4)
    held, _ = _rows(layout, CODES_7B, 3, seed=5)
    checks = ttrain.check_bits_for_codes(layout, strs)
    clf = tclf.train_classifier(
        torch.Generator().manual_seed(0), layout, spectra, strs, checks,
        ClassifierConfig(check_train_steps=STEPS), scaler=True,
        device="cpu")
    path = str(tmp_path / "port.npz")
    tart.save_classifier(path, clf)
    jpath = str(tmp_path / "jax.npz")
    jclf_loaded = jart.load_classifier(path)
    jart.save_classifier(jpath, jclf_loaded)
    with np.load(path) as a, np.load(jpath) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
    codes_t, prob_t, _, _ = tclf.classify(tart.load_classifier(path), held,
                                          device="cpu")
    codes_j, prob_j, _, _ = jclf_loaded.classify(jnp.asarray(held))
    assert codes_t == list(codes_j)
    np.testing.assert_allclose(prob_t, prob_j, rtol=1e-5, atol=1e-6)


def test_classifier_config_and_code_converters_equal_the_reference():
    import dataclasses

    from hiprfish_tpu import config as jconfig
    from hiprfish_tpu_torch import config as tconfig

    assert [f.name for f in dataclasses.fields(ClassifierConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    assert dataclasses.asdict(ClassifierConfig()) == \
        dataclasses.asdict(JConfig())
    assert tconfig.SEVEN_BIT_SUBSET == jconfig.SEVEN_BIT_SUBSET
    for enc in range(1024):
        code = TEN_BIT.code_str(enc)
        assert tconfig.convert_code_to_7b(code) == \
            jconfig.convert_code_to_7b(code)
    for enc in range(128):
        code = SEVEN_BIT.code_str(enc)
        assert tconfig.convert_code_to_10b(code) == \
            jconfig.convert_code_to_10b(code)
