"""Write the real-sklearn legacy classifier fixture: two small stacks in
the reference trainer's own format, made with sklearn and joblib.dump, and
sklearn's own answers on held-out rows, under tests/fixtures/legacy_stacks/:

* ref10_umap_transform.pkl, ref10_umap_transformed_svc.pkl,
  ref10_umap_transformed_check_svc.pkl: the 10-bit layout (95 channels +
  31 violet derivative + 6 check bits), joblib uncompressed; the embedded
  SVC's classes are an object array of code strings (a pandas column in
  the reference);
* ref7_umap_transform_biofilm_7b.pkl and its _svc, _check_svc and _scaler
  pickles: the 7-bit layout (63 channels + 4 check bits, the check SVCs on
  StandardScaler-scaled blocks), joblib zlib (the UMAP and the scaler) and
  gzip (the SVCs) compressed;
* answers.npz: per stack the held-out feature rows (check columns zero)
  and their codes, the check SVCs' inputs and sklearn's predictions on
  them, and points near the embedding's clusters with the embedded SVC's
  predict and predict_proba.

The UMAPs are fitted-UMAP objects faked under umap.umap_.UMAP (no
umap-learn here either): the training rows, an embedding with one
cluster per code on a circle, and the metric recorded by reference as the
reference trainer's numba function. The files hold what the legacy
classifiers read; the port reads them with neither sklearn nor joblib.
Needs sklearn and joblib; imports nothing of the JAX package. Run from the
repository root:

    python tools/make_torch_legacy_fixture.py [OUT_DIR]
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "fixtures", "legacy_stacks")

# eight codes per layout whose check bits all vary across them
CODES_10B = (5, 37, 515, 1023, 96, 640, 17, 260)
CODES_7B = (1, 9, 65, 127, 34, 88, 24, 112)
TRAIN_ROWS = 24
HELD_OUT_ROWS = 4
N_NEIGHBORS = 10


def _fake_modules(metric: str):
    """Modules under which a faked UMAP class and the metric's function
    pickle by reference."""
    umap = types.ModuleType("umap")
    umap_ = types.ModuleType("umap.umap_")
    ref = types.ModuleType("hiprfish_imaging_train_reference")

    class UMAP:
        pass

    UMAP.__module__, UMAP.__qualname__ = "umap.umap_", "UMAP"
    umap_.UMAP = UMAP
    umap.umap_ = umap_

    def fn(x, y):
        raise AssertionError("never called")

    fn.__module__ = ref.__name__
    fn.__name__ = fn.__qualname__ = metric
    setattr(ref, metric, fn)
    return {"umap": umap, "umap.umap_": umap_, ref.__name__: ref}, UMAP, fn


def _rows(layout, codes, n, rng, derivative):
    from hiprfish_tpu_torch.utils import synthetic

    lut = synthetic.fluorophore_spectra(layout)
    out = []
    for c in codes:
        spec = synthetic.barcode_spectrum(layout, c, lut)
        r = np.clip(rng.uniform(0.7, 1.3, (n, 1)) * spec[None, :]
                    + rng.randn(n, layout.n_channels) * 0.02, 0, None)
        out.append(r / r.max(axis=1, keepdims=True))
    x = np.concatenate(out).astype(np.float32)
    if derivative:
        x = np.concatenate([x, np.diff(x[:, :32], axis=1)], axis=1)
    return x


def _stack(layout, codes, metric, blocks, rng, scaled: bool):
    """(UMAP state, embedded SVC, check SVCs, scaler, answers)."""
    import warnings

    from sklearn import svm
    from sklearn.preprocessing import StandardScaler

    from hiprfish_tpu_torch.config import TEN_BIT

    # probability=True is what the reference fits with (deprecated in
    # sklearn 1.9, still fitted the same way)
    warnings.filterwarnings("ignore", message="The `probability` parameter")
    from hiprfish_tpu_torch.models.train import check_bits_for_codes

    derivative = layout is TEN_BIT
    code_strs = np.array([layout.code_str(c) for c in codes])
    bits = check_bits_for_codes(layout, code_strs)
    if np.any(bits.min(axis=0) == bits.max(axis=0)):
        raise ValueError("every check bit must vary across the codes")
    y = np.repeat(np.arange(len(codes)), TRAIN_ROWS)
    spectra = _rows(layout, codes, TRAIN_ROWS, rng, derivative)
    raw = np.concatenate([spectra, bits[y]], axis=1).astype(np.float32)
    nb = spectra.shape[1] if derivative else layout.n_channels
    scaler = StandardScaler().fit(spectra[:, :nb]) if scaled else None
    check_in = scaler.transform(spectra[:, :nb]) if scaled else spectra
    checks = [svm.SVC(C=10, gamma=0.5).fit(check_in[:, lo:hi], bits[y, i])
              for i, (lo, hi) in enumerate(blocks)]
    ang = 2 * np.pi * y / len(codes)
    emb = (np.stack([8 * np.cos(ang), 8 * np.sin(ang)], 1)
           + rng.randn(len(y), 2) * 0.2).astype(np.float32)
    svc = svm.SVC(C=10, gamma=0.5, probability=True, random_state=0).fit(
        emb, np.array(code_strs[y], dtype=object))
    # held-out rows: fresh draws, check columns zero, as the CLIs build
    qy = np.repeat(np.arange(len(codes)), HELD_OUT_ROWS)
    q = _rows(layout, codes, HELD_OUT_ROWS, rng, derivative)
    q_in = scaler.transform(q[:, :nb]) if scaled else q
    feats = np.concatenate([q, np.zeros((len(qy), len(blocks)),
                                        np.float32)], axis=1)
    qang = 2 * np.pi * qy / len(codes)
    pts = np.stack([8 * np.cos(qang), 8 * np.sin(qang)], 1) \
        + rng.randn(len(qy), 2) * 0.5
    answers = {
        "queries": feats, "labels": code_strs[qy],
        "check_pred": np.stack([c.predict(q_in[:, lo:hi])
                                for c, (lo, hi) in zip(checks, blocks)]),
        "embed_points": pts,
        "embed_pred": svc.predict(pts).astype(str),
        "embed_proba": svc.predict_proba(pts)}
    state = {"_raw_data": raw, "embedding_": emb, "_a": np.float64(1.577),
             "_b": np.float64(0.8951), "n_neighbors": N_NEIGHBORS,
             "n_components": 2, "min_dist": 0.1}
    return state, svc, checks, scaler, answers


def build(out: str = OUT) -> dict:
    import joblib

    from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
    from hiprfish_tpu_torch.utils.legacy_stacks import CHECK_BLOCKS, METRICS

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(0)
    arrays = {}
    for tag, layout, codes in (("10b", TEN_BIT, CODES_10B),
                               ("7b", SEVEN_BIT, CODES_7B)):
        state, svc, checks, scaler, answers = _stack(
            layout, codes, METRICS[tag], CHECK_BLOCKS[tag], rng,
            scaled=layout is SEVEN_BIT)
        modules, umap_cls, metric_fn = _fake_modules(METRICS[tag])
        umap_obj = umap_cls()
        umap_obj.__dict__.update(state, metric=metric_fn)
        if layout is TEN_BIT:
            prefix = os.path.join(out, "ref10_umap_")
            files = ((f"{prefix}transform.pkl", umap_obj, 0),
                     (f"{prefix}transformed_svc.pkl", svc, 0),
                     (f"{prefix}transformed_check_svc.pkl", checks, 0))
        else:
            prefix = os.path.join(out, "ref7_umap_transform")
            files = ((f"{prefix}_biofilm_7b.pkl", umap_obj, ("zlib", 3)),
                     (f"{prefix}ed_biofilm_7b_svc.pkl", svc, ("gzip", 3)),
                     (f"{prefix}ed_biofilm_7b_check_svc.pkl", checks,
                      ("gzip", 3)),
                     (f"{prefix}ed_biofilm_7b_scaler.pkl", scaler,
                      ("zlib", 3)))
        sys.modules.update(modules)
        try:
            for path, obj, compress in files:
                joblib.dump(obj, path, compress=compress)
        finally:
            for name in modules:
                sys.modules.pop(name, None)
        arrays.update({f"{k}_{tag}": v for k, v in answers.items()})
    np.savez_compressed(os.path.join(out, "answers.npz"), **arrays)
    return {name: os.path.getsize(os.path.join(out, name))
            for name in sorted(os.listdir(out))}


if __name__ == "__main__":
    sizes = build(sys.argv[1] if len(sys.argv) > 1 else OUT)
    for name, size in sizes.items():
        print(f"{name}: {size} bytes")
    print(f"total {sum(sizes.values())} bytes")
