"""Port parity for the legacy classify routes
(hiprfish_tpu_torch/pipeline/classify.classify_ecoli_legacy,
classify_spectra_7b_legacy and the -rf / -r *.pkl routes of cli.classify
and cli.classify_spectra) against the JAX package, on the same stacks and
measured files, with the JAX key chain's negative draws fed to the port:

- the stacks are tests/test_umap_infer.py's 10-bit and 7-bit recipes
  (sklearn SVCs dumped by joblib, a fitted UMAP faked under umap.umap_
  and written with plain pickle, which the JAX loader reads), with the
  metrics the reference fits them under recorded by reference;
- _cell_ids.txt, _avgint_ids.csv (float64 features, check columns zero)
  and _cell_information.csv (float32 features with the predicted bits,
  shape columns) are byte-identical; _identification.png decodes to the
  JAX package's label2rgb pixels.
"""

import os
import pickle
import shutil

import joblib
import numpy as np
import pytest
import torch
from sklearn import svm
from sklearn.preprocessing import StandardScaler

from hiprfish_tpu.io import outputs as joutputs
from hiprfish_tpu.pipeline import classify as jclassify
from hiprfish_tpu_torch.cli import classify as cli_classify
from hiprfish_tpu_torch.cli import classify_spectra as cli_spectra
from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.models import umap_infer
from hiprfish_tpu_torch.pipeline import classify
from tests.test_torch_io import decode_png
from tests.test_torch_legacy_pickle import FakeModules
from tests.test_torch_umap_infer import jax_negatives

torch.set_num_threads(1)

N_CELLS = 24
METRICS = {"10b": "channel_cosine_intensity_violet_derivative_v2",
           "7b": "channel_cosine_intensity_7b_v2"}


def _dump_umap(path, raw, emb, metric):
    """A fitted umap.umap_.UMAP with the metric recorded by reference as
    the reference trainer's numba function, in plain pickle."""
    with FakeModules(metric) as fake:
        obj = fake.UMAP()
        obj.__dict__.update(_raw_data=raw, embedding_=emb, _a=1.577,
                            _b=0.8951, n_neighbors=15, metric=fake.metric)
        with open(path, "wb") as f:
            pickle.dump(obj, f)


def _segmentation(n):
    """n rectangular cells of growing size, labels 1..n."""
    seg = np.zeros((96, 96), np.int32)
    for i in range(n):
        r, c = divmod(i, 6)
        seg[r * 16 + 2:r * 16 + 6 + i % 5, c * 16 + 3:c * 16 + 8 + i % 3] \
            = i + 1
    return seg


def _stack(tag, folder, rng):
    """Write one stack and one measured FOV (sample "s") into ``folder``;
    returns (transform path, the FOV's true codes)."""
    n_classes = 4
    nch = 95 if tag == "10b" else 63
    blocks = ([(0, 32), (32, 55), (55, 75), (75, 89), (89, 95), (95, 126)]
              if tag == "10b" else [(0, 23), (23, 43), (43, 57), (57, 63)])
    centers = np.clip(rng.rand(n_classes, nch).astype(np.float32), 0.05,
                      None)
    y = np.repeat(np.arange(n_classes), 30)
    spec = np.clip(centers[y] + rng.randn(len(y), nch).astype(np.float32)
                   * 0.02, 0, None)
    spec /= spec.max(axis=1, keepdims=True)
    if tag == "10b":
        spec = np.concatenate([spec, np.diff(spec[:, :32], axis=1)], 1)
    feats = np.concatenate([spec, np.zeros((len(y), len(blocks)),
                                           np.float32)], 1)
    check_in = spec
    if tag == "7b":
        scaler = StandardScaler().fit(spec)
        check_in = scaler.transform(spec)
    checks = []
    for i, (lo, hi) in enumerate(blocks):
        bits = (y >> (i % 2)) % 2
        feats[:, spec.shape[1] + i] = bits
        checks.append(svm.SVC(C=10, gamma=0.5).fit(check_in[:, lo:hi], bits))
    ang = 2 * np.pi * y / n_classes
    emb = (np.stack([8 * np.cos(ang), 8 * np.sin(ang)], 1)
           + rng.randn(len(y), 2) * 0.2).astype(np.float32)
    width = 10 if tag == "10b" else 7
    codebook = [format(c + 1, f"0{width}b") for c in range(n_classes)]
    svc = svm.SVC(C=10, gamma=0.5).fit(emb, np.array([codebook[c]
                                                      for c in y]))
    name = ("ref_umap_transform.pkl" if tag == "10b"
            else "ref_umap_transform_biofilm_7b.pkl")
    path = os.path.join(folder, name)
    _dump_umap(path, feats, emb, METRICS[tag])
    prefix = os.path.join(folder, "ref_umap_transformed")
    if tag == "10b":
        joblib.dump(svc, prefix + "_svc.pkl")
        joblib.dump(checks, prefix + "_check_svc.pkl")
    else:
        joblib.dump(scaler, prefix + "_biofilm_7b_scaler.pkl")
        joblib.dump(svc, prefix + "_biofilm_7b_svc.pkl")
        joblib.dump(checks, prefix + "_biofilm_7b_check_svc.pkl")
    qy = rng.randint(0, n_classes, N_CELLS)
    q = np.clip(centers[qy] + rng.randn(N_CELLS, nch).astype(np.float32)
                * 0.02, 0, None) * rng.uniform(0.5, 2.0, (N_CELLS, 1))
    if tag == "10b":
        np.savetxt(os.path.join(folder, "s_avgint.csv"), q, delimiter=",")
    else:
        outputs.save_avgint_norm_csv_with_header(
            os.path.join(folder, "s_avgint_norm.csv"), q)
    np.save(os.path.join(folder, "s_seg.npy"), _segmentation(N_CELLS))
    return path, np.array([codebook[c] for c in qy]), feats.shape[0]


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    rng = np.random.RandomState(0)
    out = {}
    for tag in ("10b", "7b"):
        folder = str(tmp_path_factory.mktemp(f"stack{tag}"))
        out[tag] = (folder, *_stack(tag, folder, rng))
    return out


class _InDir:
    def __init__(self, path):
        self.path = path

    def __enter__(self):
        self.old = os.getcwd()
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _run_both(stacks, tag, tmp_path, port_fn, jax_fn):
    folder, transform, truth, n_train = stacks[tag]
    files = (["s_avgint.csv"] if tag == "10b" else ["s_avgint_norm.csv"]) \
        + ["s_seg.npy"]
    negs = jax_negatives(30, N_CELLS, 5, n_train)
    for side, fn in (("port", port_fn), ("jax", jax_fn)):
        (tmp_path / side).mkdir()
        for f in files:
            shutil.copy(os.path.join(folder, f), tmp_path / side / f)
        with _InDir(tmp_path / side):
            fn(files[0], transform, negs)
    return tmp_path / "port", tmp_path / "jax", truth


def _same_bytes(a, b):
    assert open(a, "rb").read() == open(b, "rb").read(), (a, b)


def _check_10b(port, jax_dir, truth):
    for suffix in ("_cell_ids.txt", "_avgint_ids.csv"):
        _same_bytes(port / f"s{suffix}", jax_dir / f"s{suffix}")
    codes = (port / "s_cell_ids.txt").read_text().split()
    np.testing.assert_array_equal(codes, truth)
    rows = (port / "s_avgint_ids.csv").read_text().splitlines()
    # 132 float64 features with the check columns at zero, then the code
    assert all(r.split(",")[126:132] == ["0.0"] * 6 for r in rows)
    ident = classify.paint_identification(np.load(port / "s_seg.npy"),
                                          codes, len(codes))
    np.testing.assert_array_equal(
        decode_png(port / "s_identification.png"),
        np.round(255 * joutputs.label2rgb(ident)).astype(np.uint8))


def _check_7b(port, jax_dir, truth):
    _same_bytes(port / "s_cell_information.csv",
                jax_dir / "s_cell_information.csv")
    rows = (port / "s_cell_information.csv").read_text().splitlines()
    np.testing.assert_array_equal([r.split(",")[67] for r in rows], truth)


def test_classify_ecoli_legacy_matches_jax(stacks, tmp_path):
    port, jax_dir, truth = _run_both(
        stacks, "10b", tmp_path,
        lambda f, t, negs: classify.classify_ecoli_legacy(
            f, t, device="cpu", negatives=negs),
        lambda f, t, negs: jclassify.classify_ecoli_legacy(f, t))
    _check_10b(port, jax_dir, truth)


def test_classify_spectra_7b_legacy_matches_jax(stacks, tmp_path):
    timings = {}
    port, jax_dir, truth = _run_both(
        stacks, "7b", tmp_path,
        lambda f, t, negs: classify.classify_spectra_7b_legacy(
            f, t, device="cpu", negatives=negs, timings=timings),
        lambda f, t, negs: jclassify.classify_spectra_7b_legacy(f, t))
    _check_7b(port, jax_dir, truth)
    assert set(timings) == {"load", "check SVCs", "distance and top-k",
                            "weights", "epochs", "SVC", "write"}


@pytest.mark.parametrize("tag", ["10b", "7b"])
def test_legacy_cli_routes_match_jax(stacks, tmp_path, monkeypatch, tag):
    from hiprfish_tpu.cli import classify as jcli
    from hiprfish_tpu.cli import classify_spectra as jcli_spectra

    transform_fn = umap_infer.umap_transform

    def with_jax_draws(negs):
        def run(*args, **kwargs):
            kwargs["negatives"] = negs
            return transform_fn(*args, **kwargs)
        return run

    def port(f, t, negs):
        monkeypatch.setattr(umap_infer, "umap_transform",
                            with_jax_draws(negs))
        if tag == "10b":
            cli_classify.main([f, "-rf", t, "--device", "cpu"])
        else:
            cli_spectra.main(["-i", f, "-r", t, "--device", "cpu"])

    def jax_cli(f, t, negs):
        if tag == "10b":
            jcli.main([f, "-rf", t])
        else:
            jcli_spectra.main(["-i", f, "-r", t])

    port_dir, jax_dir, truth = _run_both(stacks, tag, tmp_path, port,
                                         jax_cli)
    (_check_10b if tag == "10b" else _check_7b)(port_dir, jax_dir, truth)


@pytest.mark.parametrize("tag", ["10b", "7b"])
def test_synthetic_stack_round_trip_and_calls(tmp_path, tag):
    """utils/legacy_stacks.reference_stack at 20 rows per code (the small
    10-bit stack is chip_smoke's phase 20 (c)): its joblib-format pickles
    read back bitwise, the check SVCs call every training row's bit, and
    the stack calls the codes of code-mean feature rows."""
    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
    from hiprfish_tpu_torch.utils import legacy_stacks

    layout = TEN_BIT if tag == "10b" else SEVEN_BIT
    stack = legacy_stacks.reference_stack(layout, 20)
    files = legacy_stacks.write_stack(stack, str(tmp_path), "small")
    load = (umap_infer.load_legacy_umap_stack if tag == "10b"
            else umap_infer.load_legacy_umap_stack_7b)
    loaded = load(next(iter(files)), device="cpu")
    raw = stack.umap._raw_data
    assert loaded.umap.raw_data.tobytes() == raw.tobytes()
    assert loaded.umap.embedding.tobytes() \
        == stack.umap.embedding_.tobytes()
    assert loaded.umap.metric == legacy_stacks.METRICS[tag]
    for i, (svc, rows) in enumerate(zip(loaded.check_svcs,
                                        stack.check_rows)):
        np.testing.assert_array_equal(
            svc.predict(rows), np.repeat(stack.check_bits[:, i], 20))
    pick = np.arange(0, len(stack.code_strings), 25)
    n_checks = stack.check_bits.shape[1]
    means = raw.reshape(len(stack.code_strings), 20, -1)[pick].mean(axis=1)
    means[:, -n_checks:] = 0.0
    np.testing.assert_array_equal(loaded.predict(means).astype(str),
                                  stack.code_strings[pick])
