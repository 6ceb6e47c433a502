"""Write and read the reference's classifier ``.npz`` without jax (the
counterparts of hiprfish_tpu/models/artifacts.py::save_classifier and
load_classifier, whose module imports jax through models/classifier.py;
both packages read what either writes), and score the reference's pickled
sklearn RBF SVCs on the card (``TorchRbfSvc``, ``load_reference_svc``)
without sklearn or joblib."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from hiprfish_tpu_torch.models.legacy_pickle import permissive_load


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


# ---------------------------------------------------------------------------
# The reference's pickled sklearn RBF SVCs (the port of JaxRbfSvc and
# load_reference_svc, hiprfish_tpu/models/artifacts.py:87-215)
# ---------------------------------------------------------------------------


class TorchRbfSvc:
    """A pickled sklearn RBF SVC as torch GEMMs on ``device``:
    decision(x) = sum_s dual_s exp(-gamma |x - sv_s|^2) + b per
    one-vs-one pair, votes by pair as libsvm's predict (ties to the first
    class), Platt scaling with Wu-Lin-Weng coupling for predict_proba. The
    constructor takes JaxRbfSvc's arguments (and the device);
    ``from_pickled`` reads a pickled SVC's fields."""

    def __init__(self, support_vectors, dual_coef, intercept, gamma,
                 classes, n_support, probA=None, probB=None,
                 device=torch.device("cuda")):
        self.device = torch.device(device)
        self.sv = torch.from_numpy(
            np.ascontiguousarray(support_vectors, np.float32)).to(self.device)
        self.dual_coef = torch.from_numpy(
            np.ascontiguousarray(dual_coef, np.float32)).to(self.device)
        self.intercept = torch.from_numpy(
            np.ascontiguousarray(intercept, np.float32)).to(self.device)
        self.gamma = float(gamma)
        self.classes = np.asarray(classes)
        self.n_support = np.asarray(n_support)
        self.probA = None if probA is None or len(probA) == 0 \
            else np.asarray(probA, np.float64)
        self.probB = None if probB is None or len(probB) == 0 \
            else np.asarray(probB, np.float64)
        # one-vs-one pair p = (i, j), i < j, in libsvm's order
        k = len(self.classes)
        pi, pj = np.triu_indices(k, 1)
        self._pairs = (torch.from_numpy(pi).to(self.device),
                       torch.from_numpy(pj).to(self.device))

    @classmethod
    def from_pickled(cls, obj, device=torch.device("cuda")):
        """From a pickled SVC, stub or estimator, through its fields:
        sklearn >= 1.0 keeps _n_support, _probA, _probB (properties
        n_support_, probA_, probB_), older releases the public names."""
        state = vars(obj)

        def field(*names):
            for n in names:
                if n in state:
                    return state[n]
            return None

        gamma = field("_gamma", "gamma")
        return cls(state["support_vectors_"], state["dual_coef_"],
                   state["intercept_"], gamma, state["classes_"],
                   field("_n_support", "n_support_"),
                   field("_probA", "probA_"), field("_probB", "probB_"),
                   device=device)

    def _kernel(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(self.device, torch.float32)
        x2 = torch.sum(x * x, dim=1, keepdim=True)
        s2 = torch.sum(self.sv * self.sv, dim=1)[None, :]
        d2 = x2 + s2 - 2.0 * (x @ self.sv.T)
        return torch.exp(-self.gamma * torch.clamp(d2, min=0.0))

    def decision_function_ovo(self, x) -> torch.Tensor:
        """(Q, k (k - 1) / 2) one-vs-one decisions on ``device``: the
        per-class partial sums P[q, i, r] = sum over class i's support
        vectors s of K[q, s] dual[r, s] (one GEMM per class), then pair
        (i, j) = P[:, i, j - 1] + P[:, j, i] + b."""
        kern = self._kernel(x)
        k = len(self.classes)
        starts = np.concatenate([[0], np.cumsum(self.n_support)])
        part = torch.empty((kern.shape[0], k, k - 1), dtype=torch.float32,
                           device=self.device)
        for i in range(k):
            lo, hi = int(starts[i]), int(starts[i + 1])
            part[:, i] = kern[:, lo:hi] @ self.dual_coef[:, lo:hi].T
        pi, pj = self._pairs
        flat = part.reshape(kern.shape[0], -1)
        dec = flat.index_select(1, pi * (k - 1) + pj - 1) \
            + flat.index_select(1, pj * (k - 1) + pi)
        return dec + self.intercept

    def predict(self, x) -> np.ndarray:
        k = len(self.classes)
        dec = self.decision_function_ovo(x)
        if k == 2:
            return self.classes[(dec[:, 0] > 0).long().cpu().numpy()]
        win = (dec > 0).to(torch.int32)
        del dec
        pi, pj = self._pairs
        votes = torch.zeros((win.shape[0], k), dtype=torch.int32,
                            device=self.device)
        votes.index_add_(1, pi, win)
        votes.index_add_(1, pj, 1 - win)
        # argmax takes the first of equal maxima, as np.argmax
        return self.classes[torch.argmax(votes, dim=1).cpu().numpy()]

    def predict_proba(self, x, n_iter: int = 100) -> np.ndarray:
        """(Q, k) class probabilities, float64: per-pair Platt sigmoids of
        the decisions (probA_, probB_), coupled by libsvm's
        multiclass_probability fixed point (Wu, Lin and Weng, method 2)
        with its stopping rule. Needs an SVC fit with probability=True."""
        if self.probA is None:
            raise ValueError("SVC was not fit with probability=True")
        f64 = dict(dtype=torch.float64, device=self.device)
        dec = self.decision_function_ovo(x).to(torch.float64)
        n, k = dec.shape[0], len(self.classes)
        val = dec * torch.tensor(self.probA, **f64) \
            + torch.tensor(self.probB, **f64)
        pij = torch.clamp(1.0 / (1.0 + torch.exp(torch.clamp(val, -500, 500))),
                          1e-7, 1 - 1e-7)
        pi, pj = self._pairs
        r = torch.zeros((n, k, k), **f64)
        r[:, pi, pj] = pij
        r[:, pj, pi] = 1.0 - pij
        q = -r.transpose(1, 2) * r
        diag = torch.arange(k, device=self.device)
        q[:, diag, diag] = (r ** 2).sum(dim=1) - r[:, diag, diag] ** 2
        prob = torch.full((n, k), 1.0 / k, **f64)
        for _ in range(n_iter):
            qp = torch.einsum("nij,nj->ni", q, prob)
            pqp = torch.einsum("ni,ni->n", prob, qp)
            if float(torch.abs(qp - pqp[:, None]).max()) < 0.005 / k:
                break
            for t in range(k):
                diff = (-qp[:, t] + pqp) / q[:, t, t]
                prob[:, t] += diff
                pqp = ((pqp + diff * (diff * q[:, t, t] + 2 * qp[:, t]))
                       / (1 + diff) ** 2)
                qp = (qp + diff[:, None] * q[:, t, :]) / (1 + diff)[:, None]
                prob /= (1 + diff)[:, None]
        return (prob / prob.sum(dim=1, keepdim=True)).cpu().numpy()


def load_reference_svc(path: str, device=torch.device("cuda")):
    """A reference joblib SVC pickle as a TorchRbfSvc, or a list of them
    for the check-SVC pickle, read without sklearn or joblib."""
    obj = permissive_load(path)
    if isinstance(obj, list):
        return [TorchRbfSvc.from_pickled(s, device) for s in obj]
    return TorchRbfSvc.from_pickled(obj, device)
