"""Write and read the reference's classifier ``.npz`` without jax (the
counterparts of hiprfish_tpu/models/artifacts.py::save_classifier and
load_classifier, whose module imports jax through models/classifier.py).
Both packages read what either writes."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ClassifierArrays:
    """The fields of the reference's SpectralClassifier, as numpy arrays
    and plain metadata."""

    layout_name: str
    n_channels: int
    blocks: Tuple[Tuple[int, int], ...]
    check_slice: Tuple[int, int]
    codebook: Tuple[str, ...]
    train_features: np.ndarray
    train_labels: np.ndarray
    check_params: Tuple[dict, ...]
    check_blocks: Tuple[Tuple[int, int], ...]
    scaler_mean: Optional[np.ndarray] = None
    scaler_scale: Optional[np.ndarray] = None
    n_neighbors: int = 25
    temperature: float = 30.0
    violet_derivative: bool = False
    full_derivative: bool = False


def save_classifier(path: str, clf: ClassifierArrays) -> None:
    """Write the keys load_classifier reads, with the reference's
    meta_json (the same keys in the same order), compressed."""
    arrays = {
        "train_features": clf.train_features,
        "train_labels": clf.train_labels,
    }
    if clf.scaler_mean is not None:
        arrays["scaler_mean"] = clf.scaler_mean
        arrays["scaler_scale"] = clf.scaler_scale
    for b, params in enumerate(clf.check_params):
        for k, v in params.items():
            arrays[f"check{b}/{k}"] = np.asarray(v)
    meta = {
        "layout_name": clf.layout_name,
        "n_channels": clf.n_channels,
        "blocks": [list(b) for b in clf.blocks],
        "check_slice": list(clf.check_slice),
        "codebook": list(clf.codebook),
        "check_blocks": [list(b) for b in clf.check_blocks],
        "n_neighbors": clf.n_neighbors,
        "temperature": clf.temperature,
        "violet_derivative": clf.violet_derivative,
        "full_derivative": clf.full_derivative,
        "n_check_heads": len(clf.check_params),
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_classifier(path: str) -> ClassifierArrays:
    """Load the keys train_features, train_labels, check{b}/{w1,b1,w2,b2},
    scaler_mean/scaler_scale (optional) and meta_json."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        check_params = tuple(
            {k: z[f"check{b}/{k}"] for k in ("w1", "b1", "w2", "b2")}
            for b in range(meta["n_check_heads"]))
        return ClassifierArrays(
            layout_name=meta["layout_name"],
            n_channels=meta["n_channels"],
            blocks=tuple(tuple(b) for b in meta["blocks"]),
            check_slice=tuple(meta["check_slice"]),
            codebook=tuple(meta["codebook"]),
            train_features=z["train_features"],
            train_labels=z["train_labels"],
            check_params=check_params,
            check_blocks=tuple(tuple(b) for b in meta["check_blocks"]),
            scaler_mean=z["scaler_mean"] if "scaler_mean" in z else None,
            scaler_scale=z["scaler_scale"] if "scaler_scale" in z else None,
            n_neighbors=meta["n_neighbors"],
            temperature=meta["temperature"],
            violet_derivative=meta["violet_derivative"],
            full_derivative=meta.get("full_derivative", False),
        )
