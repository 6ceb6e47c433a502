"""The port's pickle reader (hiprfish_tpu_torch/models/legacy_pickle.py,
models/umap_infer.load_umap_pickle, models/artifacts.load_reference_svc)
against the JAX loader and against joblib.load, with sklearn and joblib
present here but never used by the port:

- plain-pickle fake UMAPs (tests/test_umap_infer.py's and
  tests/test_reference_metrics.py's recipes) give the JAX loader's arrays
  bitwise, a, b, n_neighbors and the metric's name;
- a joblib.dump'ed fake UMAP, which the JAX loader refuses (its C
  unpickler leaves joblib's raw array bytes in the stream), gives
  joblib.load's arrays bitwise, uncompressed, zlib and gzip, with
  Fortran-order, big-endian and object arrays;
- joblib-dumped real sklearn SVCs, an SVC list and a StandardScaler give
  JaxRbfSvc.from_sklearn's fields bitwise, as stubs, not sklearn classes;
- old-style n_support_ / probA_ / probB_ fields are read;
- other compressors, joblib < 0.10 side-file arrays and non-UMAP pickles
  raise ValueError; the synthetic-stack writer's files load in joblib.
"""

import pickle
import sys
import types

import joblib
import numpy as np
import pytest
import torch
from sklearn import svm
from sklearn.preprocessing import StandardScaler

from hiprfish_tpu.models import umap_infer as jumap
from hiprfish_tpu.models.artifacts import JaxRbfSvc
from hiprfish_tpu_torch.models import legacy_pickle
from hiprfish_tpu_torch.models import umap_infer
from hiprfish_tpu_torch.models.artifacts import (TorchRbfSvc,
                                                 load_reference_svc)
from hiprfish_tpu_torch.utils import legacy_stacks

torch.set_num_threads(1)

METRIC = "channel_cosine_intensity_7b_v2"


class FakeModules:
    """umap.umap_.UMAP and the reference trainer's metric function
    ``metric`` as importable globals while a pickle is written (or joblib
    reads one)."""

    def __init__(self, metric=METRIC):
        self.name = metric

    def __enter__(self):
        self.mods = {n: types.ModuleType(n) for n in (
            "umap", "umap.umap_", "hiprfish_imaging_train_reference")}

        class UMAP:
            pass

        UMAP.__module__, UMAP.__qualname__ = "umap.umap_", "UMAP"

        def metric(x, y):
            raise AssertionError("never called")

        metric.__module__ = "hiprfish_imaging_train_reference"
        metric.__name__ = metric.__qualname__ = self.name
        self.mods["umap.umap_"].UMAP = UMAP
        setattr(self.mods["hiprfish_imaging_train_reference"], self.name,
                metric)
        self.UMAP, self.metric = UMAP, metric
        sys.modules.update(self.mods)
        return self

    def __exit__(self, *exc):
        for name in self.mods:
            sys.modules.pop(name, None)


def _umap_state(rng, metric):
    return {"_raw_data": rng.rand(50, 67).astype(np.float32),
            "embedding_": rng.rand(50, 2).astype(np.float32),
            "_a": np.float64(1.25), "_b": 0.79, "n_neighbors": 7,
            "metric": metric}


@pytest.mark.parametrize("metric", ["euclidean", "numba"])
def test_plain_pickle_matches_jax_loader(tmp_path, metric):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "umap_transform.pkl")
    with FakeModules() as fake:
        obj = fake.UMAP()
        obj.__dict__.update(_umap_state(
            rng, "euclidean" if metric == "euclidean" else fake.metric))
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    assert "umap" not in sys.modules
    want = jumap.load_umap_pickle(path)
    got = umap_infer.load_umap_pickle(path)
    for field in ("raw_data", "embedding"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (got.a, got.b, got.n_neighbors, got.metric) \
        == (want.a, want.b, want.n_neighbors, want.metric)
    assert got.metric == ("euclidean" if metric == "euclidean" else METRIC)


@pytest.mark.parametrize("compress", [0, ("zlib", 3), ("gzip", 3)])
def test_joblib_umap_read_bitwise_where_jax_loader_fails(tmp_path,
                                                         compress):
    rng = np.random.RandomState(1)
    path = str(tmp_path / "umap_transform.pkl")
    with FakeModules() as fake:
        obj = fake.UMAP()
        obj.__dict__.update(_umap_state(rng, fake.metric))
        # the other layouts joblib frames: Fortran order, big-endian, and
        # an object array (a nested pickle in the same file)
        obj.fortran = np.asfortranarray(rng.rand(7, 5))
        obj.big = rng.rand(6).astype(">f8")
        obj.labels = np.array(["0000001", "1000000", 3], dtype=object)
        joblib.dump(obj, path, compress=compress)
        ref = joblib.load(path)
    if not compress:
        # the JAX loader's C unpickler never reads joblib's array bytes
        with pytest.raises(pickle.UnpicklingError):
            jumap.load_umap_pickle(path)
    got = legacy_pickle.permissive_load(path)
    assert type(got).__name__ == "UMAP" and type(got).__module__ != \
        "umap.umap_"
    for name in ("_raw_data", "embedding_", "fortran", "big"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert a.dtype.isnative and a.astype(b.dtype).tobytes() \
            == b.tobytes()
    assert list(got.labels) == list(ref.labels)
    model = umap_infer.load_umap_pickle(path)
    assert model.raw_data.tobytes() == ref._raw_data.tobytes()
    assert (model.a, model.b, model.n_neighbors, model.metric) \
        == (1.25, 0.79, 7, METRIC)


def _sklearn_svcs(rng):
    x = rng.rand(200, 8)
    binary = svm.SVC(C=10, gamma=0.5).fit(x, (x[:, 0] > 0.5).astype(int))
    multi = svm.SVC(C=10, gamma=0.5, probability=True, random_state=0).fit(
        x, np.array(["a", "bb", "ccc"])[(x[:, 1] * 3).astype(int)])
    strings = svm.SVC(C=10, gamma=0.5).fit(
        x, np.where(x[:, 2] > 0.5, "0000000101", "0001000000"))
    return [binary, multi, strings]


def _assert_same_fields(got: TorchRbfSvc, want: JaxRbfSvc):
    for name in ("sv", "dual_coef", "intercept"):
        a = getattr(got, name).numpy()
        assert a.tobytes() == getattr(want, name).tobytes(), name
    assert got.gamma == want.gamma
    assert list(got.classes) == list(want.classes)
    assert got.n_support.tolist() == want.n_support.tolist()
    for name in ("probA", "probB"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("compress", [0, ("gzip", 3)])
def test_joblib_sklearn_svcs_and_scaler_match_jax_fields(tmp_path, compress):
    rng = np.random.RandomState(2)
    svcs = _sklearn_svcs(rng)
    joblib.dump(svcs[1], tmp_path / "svc.pkl", compress=compress)
    joblib.dump(svcs, tmp_path / "checks.pkl", compress=compress)
    scaler = StandardScaler().fit(rng.rand(30, 63))
    joblib.dump(scaler, tmp_path / "scaler.pkl", compress=compress)

    one = load_reference_svc(str(tmp_path / "svc.pkl"), "cpu")
    _assert_same_fields(one, JaxRbfSvc.from_sklearn(svcs[1]))
    many = load_reference_svc(str(tmp_path / "checks.pkl"), "cpu")
    assert len(many) == 3
    for got, ref in zip(many, svcs):
        _assert_same_fields(got, JaxRbfSvc.from_sklearn(ref))
    raw = legacy_pickle.permissive_load(str(tmp_path / "checks.pkl"))
    # stubs, although sklearn is importable here
    assert all(isinstance(s, legacy_pickle._Stub) for s in raw)
    st = legacy_pickle.permissive_load(str(tmp_path / "scaler.pkl"))
    assert isinstance(st, legacy_pickle._Stub)
    for name in ("mean_", "scale_", "var_"):
        assert getattr(st, name).tobytes() == getattr(scaler, name).tobytes()


def test_old_style_svc_fields(tmp_path):
    """Releases before sklearn 1.0 pickled n_support_, probA_ and probB_
    under their public names."""
    rng = np.random.RandomState(3)
    ref = _sklearn_svcs(rng)[1]
    state = {"support_vectors_": ref.support_vectors_,
             "dual_coef_": ref.dual_coef_, "intercept_": ref.intercept_,
             "gamma": 0.5, "classes_": ref.classes_,
             "n_support_": ref.n_support_, "probA_": ref.probA_,
             "probB_": ref.probB_}
    path = str(tmp_path / "old_svc.pkl")
    legacy_stacks.joblib_dump(
        legacy_stacks.fake_object("sklearn.svm.classes.SVC", state), path)
    got = load_reference_svc(path, "cpu")
    _assert_same_fields(got, JaxRbfSvc.from_sklearn(ref))
    x = rng.rand(40, 8)
    np.testing.assert_array_equal(got.predict(x), ref.predict(x))


def test_refusals(tmp_path):
    path = tmp_path / "not_umap.pkl"
    with open(path, "wb") as f:
        pickle.dump({"just": "a dict"}, f)
    with pytest.raises(ValueError, match="fitted UMAP"):
        umap_infer.load_umap_pickle(str(path))
    for name in ("bz2", "lzma", "xz"):
        p = tmp_path / f"x_{name}.pkl"
        joblib.dump(np.arange(5), p, compress=(name, 3))
        with pytest.raises(ValueError, match=name):
            legacy_pickle.permissive_load(str(p))
    old = legacy_stacks.fake_object(
        "joblib.numpy_pickle_compat.NDArrayWrapper",
        {"filename": "x_01.npy", "subclass": np.ndarray})
    p = tmp_path / "old_joblib.pkl"
    legacy_stacks.joblib_dump([old], str(p), protocol=2)
    with pytest.raises(ValueError, match="side files"):
        legacy_pickle.permissive_load(str(p))


def test_writer_files_load_in_joblib(tmp_path):
    """legacy_stacks.joblib_dump writes what joblib.load reads, with the
    fake classes' modules present."""
    rng = np.random.RandomState(4)
    with FakeModules():
        state = _umap_state(rng, "euclidean")
        path = str(tmp_path / "w.pkl")
        legacy_stacks.joblib_dump(
            legacy_stacks.fake_object("umap.umap_.UMAP", dict(
                state, labels=np.array(["a", 1], dtype=object),
                empty=np.zeros((0, 3), np.float32))), path)
        ref = joblib.load(path)
    got = legacy_pickle.permissive_load(path)
    for name in ("_raw_data", "embedding_", "empty"):
        assert getattr(got, name).tobytes() == getattr(ref, name).tobytes()
        assert getattr(got, name).shape == getattr(ref, name).shape
    assert list(got.labels) == list(ref.labels)
