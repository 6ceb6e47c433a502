"""The spectral classifier at inference (torch port of the inference half
of hiprfish_tpu/models/classifier.py): the check-bit heads and
``classify``, the counterpart of SpectralClassifier.classify over
pipeline/fused.classify_device."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class CheckHead(nn.Module):
    """relu(x @ w1 + b1) @ w2 + b2 -> one logit per row (the check bit is
    logit > 0). Inference only: from_numpy freezes the parameters."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d_in, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    @property
    def d_in(self) -> int:
        return self.fc1.in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))[:, 0]

    @classmethod
    def from_numpy(cls, params: dict,
                   device=torch.device("cuda")) -> "CheckHead":
        """Build from the reference's {w1 (d_in, hidden), b1, w2 (hidden,
        1), b2} arrays; nn.Linear keeps (out, in), so the weights are
        transposed. The head goes to the card unless the caller names
        another device."""
        w1 = np.asarray(params["w1"], np.float32)
        w2 = np.asarray(params["w2"], np.float32)
        head = cls(w1.shape[0], w1.shape[1])
        with torch.no_grad():
            head.fc1.weight.copy_(torch.from_numpy(w1.T.copy()))
            head.fc1.bias.copy_(torch.from_numpy(
                np.asarray(params["b1"], np.float32)))
            head.fc2.weight.copy_(torch.from_numpy(w2.T.copy()))
            head.fc2.bias.copy_(torch.from_numpy(
                np.asarray(params["b2"], np.float32)))
        return head.requires_grad_(False).to(device).eval()


def feature_base(avgint_norm: torch.Tensor, clf) -> torch.Tensor:
    """The classifier's spectral features before the check bits: the first
    n_channels columns, then np.diff of the first block (violet
    derivative, the 10-bit classifier) or of all channels
    (full_derivative)."""
    x = avgint_norm[:, :clf.n_channels]
    if clf.violet_derivative:
        lo, hi = clf.blocks[0]
        return torch.cat([x, torch.diff(x[:, lo:hi], dim=1)], dim=1)
    if clf.full_derivative:
        return torch.cat([x, torch.diff(x, dim=1)], dim=1)
    return x


def classify(clf, avgint_norm, device=torch.device("cuda")):
    """Normalized spectra -> (barcode strings, max_prob, probs, features),
    the last three as numpy: check heads and the gated block-cosine kNN
    vote over k = min(n_neighbors, prototypes - 1) neighbours, in float32
    with TF32 off. ``clf`` is a models/artifacts.ClassifierArrays;
    ``avgint_norm`` an (n, C) array, cast to float32. The tensors go to
    the card unless the caller names another device."""
    from hiprfish_tpu_torch.pipeline import fused

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays, (n_classes, blocks, check_slice, n_channels, k, temperature,
             check_blocks) = fused.classifier_from_numpy(clf, device)
    n_train = arrays["train_features"].shape[0]
    k = min(k, n_train - 1) if n_train > 1 else 1
    x = torch.from_numpy(np.ascontiguousarray(avgint_norm, np.float32)) \
        .to(device)
    code_idx, max_prob, probs, feats = fused.classify_device(
        feature_base(x, clf), arrays["check_heads"], check_blocks,
        arrays.get("scaler_mean"), arrays.get("scaler_scale"),
        arrays["train_features"], arrays["train_labels"], n_classes, blocks,
        check_slice, n_channels, k, temperature, full=True)
    codes = [clf.codebook[int(i)] for i in code_idx.cpu().numpy()]
    return codes, max_prob.cpu().numpy(), probs.cpu().numpy(), \
        feats.cpu().numpy()
