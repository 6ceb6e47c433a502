"""Check-bit heads of the spectral classifier (torch port of
hiprfish_tpu/models/classifier.py::_mlp_logit)."""

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
