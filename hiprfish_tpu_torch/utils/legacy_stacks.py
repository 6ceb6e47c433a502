"""Synthetic legacy classifier stacks, written in the reference trainer's
joblib format without sklearn, joblib or umap-learn.

``joblib_dump`` writes a pickle with joblib's array framing (each numpy
array a ``joblib.numpy_pickle.NumpyArrayWrapper`` followed by a padding
byte, padding to 16 bytes and the raw C-order bytes; object arrays as a
nested protocol-5 pickle). ``fake_object`` makes an object that pickles
under any class name (``umap.umap_.UMAP``, ``sklearn.svm._classes.SVC``,
...), with the attribute names sklearn 1.9 pickles.

``reference_stack`` builds a stack over the committed fixtures' training
rows (``utils/synthetic.fixture_training_set``) with the check bits of
``models/train.check_bits_for_codes`` and ``write_stack`` writes it under
the reference's file names:

* the UMAP: the training rows, each code's rows jittered around its own
  point of a square grid (the embedding), n_neighbors, a, b and the metric
  recorded by reference as the reference's numba function;
* the embedded SVC: one support vector per code at its grid point,
  one-vs-one coefficients +1 / -1 and zero intercepts, which calls the
  nearest grid point;
* the check SVCs: each code's mean check-block spectrum as a support
  vector labelled with the code's check bit, coefficients +1 (bit 1) and
  -1 (bit 0) and a sharp kernel, which calls the bit of the nearest means;
* 7-bit: the StandardScaler of the 63 channels, whose scaled blocks the
  check SVCs read.
"""

from __future__ import annotations

import copyreg
import os
import pickle
from typing import NamedTuple

import numpy as np

from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT, ChannelLayout

_FAKE_CLASSES: dict = {}


def fake_class(qualified: str) -> type:
    """A class that pickles as the global ``qualified`` (module.name)."""
    if qualified not in _FAKE_CLASSES:
        module, _, name = qualified.rpartition(".")
        _FAKE_CLASSES[qualified] = type(name, (), {
            "__module__": module, "__qualname__": name, "_fake_global": True})
    return _FAKE_CLASSES[qualified]


def fake_object(qualified: str, state: dict):
    """An instance of ``fake_class(qualified)`` holding ``state``: it
    pickles as NEWOBJ of that class, then BUILD with the state."""
    obj = copyreg.__newobj__(fake_class(qualified))
    obj.__dict__.update(state)
    return obj


class _JoblibPickler(pickle._Pickler):
    """The pure-Python pickler with joblib's NumpyPickler.save for arrays
    and fake classes written by name."""

    def __init__(self, file, protocol: int = 4):
        super().__init__(file, protocol=protocol)
        self._fh = file

    def save_global(self, obj, name=None):
        if not getattr(obj, "_fake_global", False):
            return super().save_global(obj, name)
        module, qual = obj.__module__, obj.__qualname__
        if self.proto >= 4:
            self.save(module)
            self.save(qual)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qual}\n".encode())
        self.memoize(obj)

    def save(self, obj, save_persistent_id=True):
        if type(obj) is not np.ndarray:
            return super().save(obj, save_persistent_id)
        array = np.ascontiguousarray(obj)
        object_array = array.dtype.hasobject
        super().save(fake_object("joblib.numpy_pickle.NumpyArrayWrapper", {
            "subclass": np.ndarray, "shape": array.shape, "order": "C",
            "dtype": array.dtype, "allow_mmap": not object_array,
            "numpy_array_alignment_bytes": 16}))
        if self.proto >= 4:
            self.framer.commit_frame(force=True)
        if object_array:
            pickle.dump(array, self._fh, protocol=5)
            return
        pad = 16 - (self._fh.tell() + 1) % 16
        self._fh.write(bytes([pad]) + b"\xff" * pad)
        if array.size:
            self._fh.write(memoryview(array.reshape(-1).view(np.uint8)))


def joblib_dump(obj, path: str, protocol: int = 4) -> int:
    """Write ``obj`` in joblib's uncompressed format; returns the bytes
    written."""
    with open(path, "wb") as f:
        _JoblibPickler(f, protocol).dump(obj)
        return f.tell()


# ---------------------------------------------------------------------------
# sklearn's and umap-learn's pickled fields
# ---------------------------------------------------------------------------


def fake_svc(support_vectors, dual_coef, intercept, gamma, classes,
             n_support, probA=None, probB=None):
    """An ``sklearn.svm._classes.SVC`` with the fields a scorer reads,
    under sklearn 1.9's pickled names (public dual_coef_ and intercept_;
    libsvm's own, negated for two classes, as _dual_coef_ and _intercept_;
    _n_support, _probA, _probB, _gamma)."""
    sv = np.asarray(support_vectors, np.float64)
    dual = np.asarray(dual_coef, np.float64)
    icpt = np.asarray(intercept, np.float64)
    sign = -1.0 if len(classes) == 2 else 1.0
    empty = np.zeros(0, np.float64)
    return fake_object("sklearn.svm._classes.SVC", {
        "kernel": "rbf", "gamma": "scale", "C": 1.0,
        "probability": probA is not None, "_sparse": False,
        "n_features_in_": sv.shape[1], "classes_": classes,
        "_gamma": float(gamma), "support_vectors_": sv,
        "_n_support": np.asarray(n_support, np.int32),
        "dual_coef_": dual, "intercept_": icpt,
        "_dual_coef_": sign * dual, "_intercept_": sign * icpt,
        "_probA": empty if probA is None else np.asarray(probA, np.float64),
        "_probB": empty if probB is None else np.asarray(probB, np.float64),
        "_sklearn_version": "1.9.0"})


def fake_scaler(mean, scale, n_samples: int):
    """A ``sklearn.preprocessing._data.StandardScaler``."""
    mean = np.asarray(mean, np.float64)
    return fake_object("sklearn.preprocessing._data.StandardScaler", {
        "with_mean": True, "with_std": True, "copy": True,
        "n_features_in_": mean.shape[0], "n_samples_seen_": n_samples,
        "mean_": mean, "var_": np.asarray(scale, np.float64) ** 2,
        "scale_": np.asarray(scale, np.float64),
        "_sklearn_version": "1.9.0"})


def fake_umap(raw_data, embedding, metric: str, n_neighbors: int = 25,
              a: float = 1.577, b: float = 0.8951):
    """A fitted ``umap.umap_.UMAP`` with its training rows, embedding and
    curve, the metric recorded by reference as the reference trainer's
    numba function ``metric``."""
    return fake_object("umap.umap_.UMAP", {
        "n_neighbors": n_neighbors, "n_components": embedding.shape[1],
        "metric": fake_class(f"hiprfish_imaging_train_reference.{metric}"),
        "min_dist": 0.1, "spread": 1.0, "n_epochs": None,
        "_a": np.float64(a), "_b": np.float64(b),
        "_raw_data": raw_data, "embedding_": embedding,
        "_small_data": False})


def nearest_point_svc(points: np.ndarray, classes: np.ndarray,
                      gamma: float):
    """An RBF SVC with one support vector per class at ``points[i]``:
    the pair (i, j) decides K(x, p_i) - K(x, p_j), so every pair of the
    nearest point's class goes to it."""
    k = len(points)
    rows = np.arange(k - 1)[:, None]
    dual = np.where(rows >= np.arange(k)[None, :], 1.0, -1.0)
    return fake_svc(points, dual, np.zeros(k * (k - 1) // 2), gamma,
                    classes, np.ones(k, np.int32))


def prototype_check_svc(prototypes: np.ndarray, bits: np.ndarray,
                        gamma: float):
    """A two-class RBF SVC (classes 0, 1) over the prototypes labelled
    ``bits``: decision sum_{bit 1} K - sum_{bit 0} K, class 1 above 0."""
    order = np.argsort(bits, kind="stable")
    sv = prototypes[order]
    b = bits[order]
    dual = np.where(b > 0, 1.0, -1.0)[None, :]
    return fake_svc(sv, dual, np.zeros(1), gamma, np.array([0, 1]),
                    np.bincount(b.astype(np.int64), minlength=2))


# ---------------------------------------------------------------------------
# Stacks over the fixtures' training rows
# ---------------------------------------------------------------------------

# the UMAP metrics the reference trainer fits each layout's stack with
METRICS = {"10b": "channel_cosine_intensity_violet_derivative_v2",
           "7b": "channel_cosine_intensity_7b_v2"}
# the check SVCs' feature blocks (image_classification.py:49-54,
# classify_spectra.py:28-33)
CHECK_BLOCKS = {"10b": ((0, 32), (32, 55), (55, 75), (75, 89), (89, 95),
                        (95, 126)),
                "7b": ((0, 23), (23, 43), (43, 57), (57, 63))}
GRID_SPACING = 10.0
GRID_JITTER = 0.3
EMBED_GAMMA = 0.02
# the check SVCs' kernel: sharp enough that the nearest means decide, soft
# enough that the 7-bit stack's scaled blocks (squared distances of tens)
# do not underflow every kernel value (they do past ~100)
CHECK_GAMMA = 10.0


class Stack(NamedTuple):
    umap: object
    svc: object
    checks: list
    scaler: object            # None for the 10-bit stack
    code_strings: np.ndarray  # (n_codes,) the codes in row order
    check_bits: np.ndarray    # (n_codes, n_checks) each code's check bits
    check_rows: list          # per check SVC, the training rows' inputs


def _grid(n: int) -> np.ndarray:
    side = int(np.ceil(np.sqrt(n)))
    i = np.arange(n)
    return (np.stack([i % side, i // side], axis=1)
            * GRID_SPACING).astype(np.float32)


def reference_stack(layout: ChannelLayout, spc: int,
                    check_gamma: float = CHECK_GAMMA, seed: int = 0,
                    n_neighbors: int = 25) -> Stack:
    """A legacy stack of ``layout`` (TEN_BIT: 95 channels + 31 violet
    derivative + 6 check bits; SEVEN_BIT: 63 + 4) over ``spc`` training
    rows per code (``fixture_training_set``); grid jitter from
    RandomState(seed)."""
    from hiprfish_tpu_torch.models.train import check_bits_for_codes
    from hiprfish_tpu_torch.utils import synthetic

    key = "10b" if layout is TEN_BIT else "7b"
    if layout is not TEN_BIT and layout is not SEVEN_BIT:
        raise ValueError("the legacy stacks exist for TEN_BIT and SEVEN_BIT")
    spectra, row_codes = synthetic.fixture_training_set(layout, spc)
    codes = np.array(row_codes[::spc])
    n_codes = len(codes)
    bits = check_bits_for_codes(layout, codes)
    raw = np.empty((spectra.shape[0], spectra.shape[1] + bits.shape[1]),
                   np.float32)
    raw[:, :spectra.shape[1]] = spectra
    raw[:, spectra.shape[1]:] = np.repeat(bits, spc, axis=0)
    del spectra
    points = _grid(n_codes)
    rng = np.random.RandomState(seed)
    emb = np.repeat(points, spc, axis=0) \
        + rng.normal(0.0, GRID_JITTER, (raw.shape[0], 2)).astype(np.float32)
    umap = fake_umap(raw, emb, METRICS[key], n_neighbors)
    svc = nearest_point_svc(points, codes.astype(object), EMBED_GAMMA)
    scaler, check_in = None, raw
    if layout is SEVEN_BIT:
        base = raw[:, :63].astype(np.float64)
        mean, scale = base.mean(axis=0), base.std(axis=0)
        scale[scale == 0] = 1.0
        scaler = fake_scaler(mean, scale, raw.shape[0])
        check_in = ((raw[:, :63] - mean.astype(np.float32))
                    / scale.astype(np.float32))
    checks, check_rows = [], []
    for i, (lo, hi) in enumerate(CHECK_BLOCKS[key]):
        rows = check_in[:, lo:hi]
        protos = rows.reshape(n_codes, spc, hi - lo).mean(axis=1)
        checks.append(prototype_check_svc(protos, bits[:, i].astype(np.int64),
                                          check_gamma))
        check_rows.append(rows)
    return Stack(umap, svc, checks, scaler, codes, bits, check_rows)


def write_stack(stack: Stack, folder: str, name: str) -> dict:
    """Write the stack's pickles under the reference's names (10-bit:
    <name>_umap_transform.pkl, _umap_transformed_svc.pkl,
    _umap_transformed_check_svc.pkl; 7-bit: <name>_umap_transform_biofilm_
    7b.pkl and the _svc, _check_svc and _scaler pickles beside it).
    Returns {path: bytes written}; the transform's path comes first."""
    prefix = os.path.join(folder, name)
    if stack.scaler is None:
        files = {f"{prefix}_umap_transform.pkl": stack.umap,
                 f"{prefix}_umap_transformed_svc.pkl": stack.svc,
                 f"{prefix}_umap_transformed_check_svc.pkl": stack.checks}
    else:
        tail = "umap_transformed_biofilm_7b"
        files = {f"{prefix}_umap_transform_biofilm_7b.pkl": stack.umap,
                 f"{prefix}_{tail}_svc.pkl": stack.svc,
                 f"{prefix}_{tail}_check_svc.pkl": stack.checks,
                 f"{prefix}_{tail}_scaler.pkl": stack.scaler}
    return {path: joblib_dump(obj, path) for path, obj in files.items()}
