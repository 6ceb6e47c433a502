"""Port parity: block-cosine distances, check heads and the kNN vote vs the
JAX package on the CPU, with the committed 127-code 7-bit and 1023-class
10-bit (violet-derivative) classifier fixtures loaded once by the JAX
loader and once by the port's jax-free loader."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT, TEN_BIT
from hiprfish_tpu.models import metrics as jmetrics
from hiprfish_tpu.models.artifacts import load_classifier as jload
from hiprfish_tpu.models.classifier import _mlp_logit
from hiprfish_tpu.pipeline import fused as jfused
from hiprfish_tpu.utils import synthetic
from hiprfish_tpu_torch.models import metrics as tmetrics
from hiprfish_tpu_torch.models.artifacts import load_classifier as tload
from hiprfish_tpu_torch.models.classifier import (CheckHead, CheckHeads,
                                                  train_classifier)
from hiprfish_tpu_torch.pipeline import fused as tfused
from hiprfish_tpu_torch.utils import synthetic3d as t3

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_7b_127x50.npz")
FIXTURE_10B = os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_port_clf_10b_1023x200.npz")


def _spectra(n, seed):
    """Noisy normalized barcode spectra, a few all-zero rows and blocks."""
    rng = np.random.RandomState(seed)
    lut = synthetic.fluorophore_spectra(SEVEN_BIT)
    rows = np.stack([synthetic.barcode_spectrum(SEVEN_BIT, 1 + i % 127, lut)
                     for i in range(n)])
    rows = np.clip(rows * rng.uniform(0.7, 1.3, (n, 1))
                   + rng.randn(n, 63) * 0.02, 0, None).astype(np.float32)
    rows /= np.maximum(rows.max(axis=1, keepdims=True), 1e-12)
    rows[0] = 0.0
    rows[1, 23:43] = 0.0
    return rows


def test_port_loader_matches_jax_loader():
    a, b = tload(FIXTURE), jload(FIXTURE)
    for f in ("layout_name", "n_channels", "blocks", "check_slice",
              "codebook", "check_blocks", "n_neighbors", "temperature"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.train_features, b.train_features)
    np.testing.assert_array_equal(a.train_labels, b.train_labels)
    for pa, pb in zip(a.check_params, b.check_params):
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(pa[k], pb[k])


@pytest.mark.parametrize("gated", [True, False])
def test_block_cosine_distance_matrix(gated):
    clf = tload(FIXTURE)
    x = np.concatenate([_spectra(40, 0),
                        (np.random.RandomState(1).rand(40, 4) > 0.5)
                        .astype(np.float32)], axis=1)
    y = clf.train_features[:300]
    cs = clf.check_slice if gated else None
    ref = np.asarray(jmetrics.block_cosine_distance_matrix(
        jnp.asarray(x), jnp.asarray(y), clf.blocks, cs))
    out = tmetrics.block_cosine_distance_matrix(
        torch.from_numpy(x), torch.from_numpy(y), clf.blocks, cs).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_check_head_matches_mlp_logit():
    clf = tload(FIXTURE)
    x = _spectra(32, 2)[:, :23]
    p = clf.check_params[0]
    ref = np.asarray(_mlp_logit({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x)))
    out = CheckHead.from_numpy(p, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_cells,cap", [(20, 32), (60, 32), (60, None)])
def test_classify_capped_matches_jax(n_cells, cap):
    ja, js = jfused.classifier_to_device_args(jload(FIXTURE))
    ta, ts = tfused.classifier_from_numpy(tload(FIXTURE), "cpu")
    rows = _spectra(64, 3)
    rows[n_cells + 1:] = 0.0
    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = js
    ci_j, mp_j = jfused.classify_capped(
        jnp.asarray(rows), jnp.int32(n_cells), cap, ja["check_params"],
        check_blocks, None, None, ja["train_features"], ja["train_labels"],
        n_classes, blocks, check_slice, n_channels, k, temperature)
    ci_t, mp_t = tfused.classify_capped(
        torch.from_numpy(rows), torch.tensor(n_cells), cap,
        ta["check_heads"], ts[6], None, None, ta["train_features"],
        ta["train_labels"], *ts[:6])
    np.testing.assert_array_equal(ci_t.numpy(), np.asarray(ci_j))
    np.testing.assert_allclose(mp_t.numpy(), np.asarray(mp_j),
                               rtol=1e-5, atol=0)
    assert (np.asarray(ci_j)[2:n_cells + 1] > 0).any()


def _spectra_10b(n, seed):
    """Noisy normalized 10-bit spectra with the violet derivative of the
    first block appended (fov_step_ecoli's 126-column feature base), a
    zero row and a zeroed 488 block."""
    rng = np.random.RandomState(seed)
    lut = synthetic.fluorophore_spectra(TEN_BIT)
    rows = np.stack([synthetic.barcode_spectrum(TEN_BIT, 1 + (i * 37) % 1023,
                                                lut) for i in range(n)])
    rows = np.clip(rows * rng.uniform(0.7, 1.3, (n, 1))
                   + rng.randn(n, 95) * 0.02, 0, None).astype(np.float32)
    rows /= np.maximum(rows.max(axis=1, keepdims=True), 1e-12)
    rows[0] = 0.0
    rows[1, 32:55] = 0.0
    return np.concatenate([rows, np.diff(rows[:, :32], axis=1)], axis=1)


def test_port_loader_matches_jax_loader_10b():
    a, b = tload(FIXTURE_10B), jload(FIXTURE_10B)
    for f in ("layout_name", "n_channels", "blocks", "check_slice",
              "codebook", "check_blocks", "n_neighbors", "temperature",
              "violet_derivative"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.violet_derivative and len(a.codebook) == 1023
    assert a.train_features.shape == (8184, 132)
    assert [hi - lo for lo, hi in a.check_blocks] == [32, 23, 20, 14, 6, 31]
    assert a.check_blocks[-1] == (95, 126) and a.check_slice == (126, 132)
    np.testing.assert_array_equal(a.train_features, b.train_features)
    np.testing.assert_array_equal(a.train_labels, b.train_labels)
    for pa, pb in zip(a.check_params, b.check_params):
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(pa[k], pb[k])


def test_classifier_from_numpy_carries_10b_heads():
    clf = tload(FIXTURE_10B)
    arrays, static = tfused.classifier_from_numpy(clf, "cpu")
    heads = arrays["check_heads"]
    assert len(heads) == 6 and {h.d_in for h in heads} == {32}
    assert static[:4] == (1023, clf.blocks, clf.check_slice, 95)
    assert static[6] == clf.check_blocks
    # every head, on its zero-padded block (the derivative head on the
    # unscaled derivative columns), equals the reference's MLP
    x = _spectra_10b(24, 4)
    for head, p, (lo, hi) in zip(heads, clf.check_params, clf.check_blocks):
        xin = np.pad(x[:, lo:hi], ((0, 0), (0, 32 - (hi - lo))))
        ref = np.asarray(_mlp_logit({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(xin)))
        np.testing.assert_allclose(head(torch.from_numpy(xin)).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)


def test_classifier_from_numpy_refuses_ragged_heads():
    clf = tload(FIXTURE)
    params = list(clf.check_params)
    params[1] = {k: (v[:10] if k == "w1" else v) for k, v in params[1].items()}
    clf.check_params = tuple(params)
    with pytest.raises(ValueError, match="one input width"):
        tfused.classifier_from_numpy(clf, "cpu")


@pytest.mark.parametrize("n_cells,cap", [(20, 32), (60, 32)])
def test_classify_capped_matches_jax_10b(n_cells, cap):
    ja, js = jfused.classifier_to_device_args(jload(FIXTURE_10B))
    ta, ts = tfused.classifier_from_numpy(tload(FIXTURE_10B), "cpu")
    rows = _spectra_10b(64, 5)
    rows[n_cells + 1:] = 0.0
    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = js
    ci_j, mp_j = jfused.classify_capped(
        jnp.asarray(rows), jnp.int32(n_cells), cap, ja["check_params"],
        check_blocks, None, None, ja["train_features"], ja["train_labels"],
        n_classes, blocks, check_slice, n_channels, k, temperature)
    ci_t, mp_t = tfused.classify_capped(
        torch.from_numpy(rows), torch.tensor(n_cells), cap,
        ta["check_heads"], ts[6], None, None, ta["train_features"],
        ta["train_labels"], *ts[:6])
    np.testing.assert_array_equal(ci_t.numpy(), np.asarray(ci_j))
    np.testing.assert_allclose(mp_t.numpy(), np.asarray(mp_j),
                               rtol=1e-5, atol=0)
    # the clean rows' calls are their barcodes
    codebook = tload(FIXTURE_10B).codebook
    calls = [codebook[i] for i in ci_t.numpy()[2:n_cells + 1]]
    truth = [TEN_BIT.code_str(1 + (i * 37) % 1023)
             for i in range(2, n_cells + 1)]
    assert np.mean([c == t for c, t in zip(calls, truth)]) >= 0.9


_SPEC = dict(shape=(48, 48, 8), spacing=(24, 24, 8), seed=0)


def _train_with_no_device_named():
    """train_classifier on 40 rows with no device named. Its generator is
    on the card where there is one: the heads' draws then succeed only if
    the training tensors are there too, so the result is a tensor on the
    generator's device."""
    from hiprfish_tpu_torch import config as tconfig
    from hiprfish_tpu_torch.models.train import check_bits_for_codes

    gen = torch.Generator("cuda" if torch.cuda.is_available() else "cpu")
    spectra = _spectra(40, 0)
    codes = [tconfig.SEVEN_BIT.code_str(1 + i % 127) for i in range(40)]
    train_classifier(gen, tconfig.SEVEN_BIT, spectra, codes,
                     check_bits_for_codes(tconfig.SEVEN_BIT, codes),
                     tconfig.ClassifierConfig(check_train_steps=2))
    return torch.empty(0, device=gen.device)


@pytest.mark.parametrize("make", [
    lambda: tfused.classifier_from_numpy(tload(FIXTURE))[0]
    ["train_features"],
    lambda: next(CheckHead.from_numpy(tload(FIXTURE).check_params[0])
                 .parameters()),
    lambda: next(CheckHeads(2, 8, 4).parameters()),
    _train_with_no_device_named,
    lambda: t3.truth_chunk(t3.VolumeSpec(**_SPEC), 63, 0, 2)[0],
    lambda: t3.build_sum_volume(t3.VolumeSpec(**_SPEC), 63, np.ones(63),
                                z_chunk=4),
], ids=["classifier_from_numpy", "CheckHead.from_numpy", "CheckHeads",
        "train_classifier", "truth_chunk", "build_sum_volume"])
def test_entry_points_default_to_the_card(make):
    # with no device named they ask for the card: on a machine without one
    # they raise rather than quietly run on the CPU
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
