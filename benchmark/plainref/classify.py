"""The plain reference's classifier: the check heads, the gated
per-laser-block cosine kNN vote, read straight from the classifier's
``.npz`` (a frozen copy of the arithmetic of hiprfish_tpu_torch's
``pipeline/fused.classify_device`` and ``models/metrics.
block_cosine_distance_matrix``; it imports nothing of the port).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .precision import FLOAT32, Precision


class Classifier:
    """The arrays of a classifier ``.npz`` on ``device``."""

    def __init__(self, path: str, device):
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            self.train_features = torch.from_numpy(
                np.asarray(z["train_features"], np.float32)).to(device)
            self.train_labels = torch.from_numpy(
                np.asarray(z["train_labels"], np.int64)).to(device)
            self.heads = [
                {k: torch.from_numpy(np.asarray(z[f"check{b}/{k}"],
                                                np.float32)).to(device)
                 for k in ("w1", "b1", "w2", "b2")}
                for b in range(meta["n_check_heads"])]
            self.scaler_mean = self.scaler_scale = None
            if "scaler_mean" in z.files:
                self.scaler_mean = torch.from_numpy(
                    np.asarray(z["scaler_mean"], np.float32)).to(device)
                self.scaler_scale = torch.from_numpy(
                    np.asarray(z["scaler_scale"], np.float32)).to(device)
        self.n_channels = meta["n_channels"]
        self.blocks = tuple(tuple(b) for b in meta["blocks"])
        self.check_slice = tuple(meta["check_slice"])
        self.check_blocks = tuple(tuple(b) for b in meta["check_blocks"])
        self.n_classes = len(meta["codebook"])
        self.k = meta["n_neighbors"]
        self.temperature = meta["temperature"]
        self.violet_derivative = meta["violet_derivative"]


def _block_normalize(a: torch.Tensor, blocks):
    """Per-block L2-normalised copy and (N, B) zero-norm indicators."""
    outs, zs = [], []
    for lo, hi in blocks:
        b = a[:, lo:hi]
        n = torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
        outs.append(torch.where(n > 0, b / torch.clamp(n, min=1e-30),
                                torch.zeros_like(b)))
        zs.append(n[:, 0] == 0)
    return torch.cat(outs, dim=1), torch.stack(zs, dim=1).to(torch.float32)


def distances(x: torch.Tensor, y: torch.Tensor, blocks, check_slice,
              p: Precision) -> torch.Tensor:
    """(N, M) gated block-cosine distances of query rows to reference
    rows (channels, then check bits)."""
    n_blocks = len(blocks)
    xn, xz = _block_normalize(x, blocks)
    yn, yz = _block_normalize(y, blocks)
    ungated = (n_blocks - p.mm(xn, yn.T) - p.mm(xz, yz.T)) / n_blocks
    clo, chi = check_slice
    xc, yc = x[:, clo:chi], y[:, clo:chi]
    diff = (torch.sum(xc, dim=1)[:, None] + torch.sum(yc, dim=1)[None, :]
            - 2.0 * p.mm(xc, yc.T))
    agree = torch.abs(diff) < 0.01
    n_checks = chi - clo
    gates = torch.stack([xc[:, min(b, n_checks - 1)]
                         for b in range(n_blocks)], dim=1)
    parts, col = [], 0
    for b, (lo, hi) in enumerate(blocks):
        parts.append(xn[:, col:col + hi - lo] * gates[:, b][:, None])
        col += hi - lo
    g_cos = p.mm(torch.cat(parts, dim=1), yn.T)
    g_both_zero = p.mm(xz * gates, yz.T)
    gated = (torch.sum(gates, dim=1)[:, None] - g_cos - g_both_zero) \
        / n_blocks
    return torch.where(agree, gated, ungated)


def classify(avgint_norm: torch.Tensor, clf: Classifier,
             p: Precision = FLOAT32):
    """(code_idx (N,) int64, max_prob (N,), scores (N, n_classes)) of
    row-max normalised spectra (N, C): the feature rows [spectra, the
    violet derivative of the first block where the classifier has it,
    check bits], then the softmax-weighted vote of the k nearest
    training rows, ties to the lower index."""
    base = avgint_norm[:, :clf.n_channels]
    if clf.violet_derivative:
        lo, hi = clf.blocks[0]
        base = torch.cat([base, torch.diff(base[:, lo:hi], dim=1)], dim=1)
    base = p.round(base)
    scaled = base[:, :clf.n_channels]
    if clf.scaler_mean is not None:
        scaled = (scaled - clf.scaler_mean) / clf.scaler_scale
    wmax = clf.heads[0]["w1"].shape[0]
    checks = []
    for head, (lo, hi) in zip(clf.heads, clf.check_blocks):
        xin = scaled[:, lo:hi] if hi <= clf.n_channels else base[:, lo:hi]
        xin = torch.nn.functional.pad(xin, (0, wmax - (hi - lo)))
        hid = torch.relu(p.round(p.mm(xin, head["w1"]) + head["b1"]))
        logit = p.round(p.mm(hid, head["w2"]) + head["b2"])[:, 0]
        checks.append((logit > 0).to(torch.float32))
    feats = torch.cat([base, torch.stack(checks, dim=1)], dim=1)
    d = p.round(distances(feats, clf.train_features, clf.blocks,
                          clf.check_slice, p))
    neg_d, idx = torch.sort(-d, dim=1, descending=True, stable=True)
    neg_d, idx = neg_d[:, :clf.k], idx[:, :clf.k]
    nb = clf.train_labels[idx]
    w = p.round(torch.softmax(neg_d * clf.temperature, dim=1))
    scores = torch.zeros((feats.shape[0], clf.n_classes),
                         dtype=torch.float32, device=feats.device)
    for j in range(nb.shape[1]):
        scores.scatter_add_(1, nb[:, j:j + 1], w[:, j:j + 1])
    scores = p.round(scores)
    return torch.argmax(scores, dim=1), torch.max(scores, dim=1).values, \
        scores
