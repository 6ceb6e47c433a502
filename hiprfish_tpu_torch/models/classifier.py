"""The spectral classifier (torch port of hiprfish_tpu/models/classifier.py).

Inference: the check-bit heads and ``classify``, the counterpart of
SpectralClassifier.classify over pipeline/fused.classify_device.

Training: ``train_classifier`` fits one check head per metric block (all
heads as one batched program, ``CheckHeads`` / ``train_check_heads``,
the counterpart of the reference's vmapped ``_train_check_head``) and
builds the kNN reference matrix in numpy, line for line as the reference
does, so its train_features and train_labels are the reference's bytes
for the same spectra. It returns a models/artifacts.ClassifierArrays.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hiprfish_tpu_torch.config import ChannelLayout, ClassifierConfig
from hiprfish_tpu_torch.models import metrics
from hiprfish_tpu_torch.models.artifacts import ClassifierArrays


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# the reference's trainer slices batches of min(4096, n) rows and ignores
# ClassifierConfig.check_batch; so does the port
CHECK_BATCH = 4096


def init_check_heads(generator: torch.Generator, n_heads: int, d_in: int,
                     hidden: int) -> dict:
    """Initial parameters of ``n_heads`` check heads, stacked on the
    generator's device: w1 ~ N(0, 1) sqrt(2 / d_in) (H, d_in, hidden),
    w2 ~ N(0, 1) sqrt(1 / hidden) (H, hidden, 1), zero biases b1 (H,
    hidden) and b2 (H, 1), the scales of the reference's _init_mlp.
    ``d_in`` is the padded width of the widest head block."""
    dev = generator.device
    w1 = torch.randn((n_heads, d_in, hidden), generator=generator,
                     device=dev) * math.sqrt(2.0 / d_in)
    w2 = torch.randn((n_heads, hidden, 1), generator=generator,
                     device=dev) * math.sqrt(1.0 / hidden)
    return {"w1": w1, "b1": torch.zeros((n_heads, hidden), device=dev),
            "w2": w2, "b2": torch.zeros((n_heads, 1), device=dev)}


class CheckHeads(nn.Module):
    """H check heads as one module: relu(x @ w1 + b1) @ w2 + b2 per head,
    one baddbmm per layer over stacked (H, d_in, hidden) and (H, hidden, 1)
    weights (the reference's jax.vmap over the heads). The parameters go
    to the card unless the caller names another device."""

    def __init__(self, n_heads: int, d_in: int, hidden: int,
                 device=torch.device("cuda")):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros((n_heads, d_in, hidden),
                                           device=device))
        self.b1 = nn.Parameter(torch.zeros((n_heads, hidden), device=device))
        self.w2 = nn.Parameter(torch.zeros((n_heads, hidden, 1),
                                           device=device))
        self.b2 = nn.Parameter(torch.zeros((n_heads, 1), device=device))

    @classmethod
    def from_params(cls, params: dict,
                    device=torch.device("cuda")) -> "CheckHeads":
        """Heads holding copies of stacked {w1, b1, w2, b2} tensors."""
        n_heads, d_in, hidden = params["w1"].shape
        heads = cls(n_heads, d_in, hidden, device)
        with torch.no_grad():
            for k, p in heads.named_parameters():
                p.copy_(torch.as_tensor(params[k]))
        return heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(H, n, d_in) -> (H, n) logits."""
        h = torch.relu(torch.baddbmm(self.b1[:, None, :], x, self.w1))
        return torch.baddbmm(self.b2[:, None, :], h, self.w2)[..., 0]


def train_check_heads(x: torch.Tensor, y: torch.Tensor, init: dict,
                      perms: torch.Tensor, steps: int, lr: float) -> dict:
    """Train H check heads on their own rows with the reference's
    _train_check_head, batched: x (H, n, d_in) padded block inputs, y
    (H, n) 0/1 targets, init the stacked initial parameters, perms (H, n)
    one permutation of the rows per head, drawn once.

    Each step i takes the contiguous batch of min(4096, n) permuted rows
    from (i * bs) % max(n - bs + 1, 1) (no reshuffle between epochs; near
    the end of an epoch the start wraps to 0) and minimises the sum over
    heads of each head's mean binary cross-entropy with logits, so every
    head's gradient is its own. Adam(lr, betas (0.9, 0.999), eps 1e-8, no
    weight decay), the update of optax.adam up to rounding; foreach=True,
    fused=False on every device. Returns the trained parameters, stacked
    and detached."""
    n_heads, n, _ = x.shape
    bs = min(CHECK_BATCH, n)
    span = max(n - bs + 1, 1)
    heads = CheckHeads.from_params(init, x.device)
    rows = torch.arange(n_heads, device=x.device)[:, None]
    xs = x[rows, perms]
    ys = y[rows, perms].to(torch.float32)
    opt = torch.optim.Adam(heads.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0, foreach=True,
                           fused=False)
    for i in range(steps):
        start = (i * bs) % span
        logit = heads(xs[:, start:start + bs])
        loss = F.binary_cross_entropy_with_logits(
            logit, ys[:, start:start + bs], reduction="none").mean(dim=1)
        opt.zero_grad(set_to_none=True)
        loss.sum().backward()
        opt.step()
    return {k: p.detach() for k, p in heads.named_parameters()}


def knn_reference(spectra: np.ndarray, code_strings: Sequence[str],
                  check_bits: np.ndarray, n_check_cols: int,
                  knn_store_per_class: int | None = None,
                  knn_prototypes_per_class: int | None | str = "auto"):
    """(codebook, train_features, train_labels) of the kNN vote, in numpy
    as the reference builds them: rows [spectra, check bits], labels the
    index of each row's code in the sorted codebook; thinned to
    ``knn_prototypes_per_class`` averaged prototypes per class (float64
    sums over linspace groups of the class's rows, check columns rounded;
    the default 8) or, when only ``knn_store_per_class`` is given, to the
    first that many rows of each class."""
    codebook = sorted(set(code_strings))
    code_to_idx = {c: i for i, c in enumerate(codebook)}
    labels = np.array([code_to_idx[c] for c in code_strings], np.int32)

    feats = np.concatenate([spectra, check_bits[:, :n_check_cols]],
                           axis=1).astype(np.float32)
    if knn_prototypes_per_class == "auto":
        knn_prototypes_per_class = \
            None if knn_store_per_class is not None else 8
    if knn_prototypes_per_class is not None:
        order = np.argsort(labels, kind="stable")
        feats_s, labels_s = feats[order], labels[order]
        # group boundaries via one reduceat pass
        _, starts = np.unique(labels_s, return_index=True)
        ends = np.append(starts[1:], len(labels_s))
        group_starts, proto_labels = [], []
        for ci, (st, en) in enumerate(zip(starts, ends)):
            p = min(knn_prototypes_per_class, en - st)
            if p == 0:
                continue
            bounds = st + np.linspace(0, en - st, p + 1)[:-1].astype(int)
            group_starts.append(np.unique(bounds))
            proto_labels.extend([int(labels_s[st])] * len(group_starts[-1]))
        group_starts = np.concatenate(group_starts)
        sums = np.add.reduceat(feats_s.astype(np.float64), group_starts,
                               axis=0)
        sizes = np.diff(np.append(group_starts, len(labels_s)))
        feats = (sums / sizes[:, None]).astype(np.float32)
        labels = np.asarray(proto_labels, np.int32)
        # the check columns gate the metric: keep them 0/1 against float
        # drift (they are constant within a class)
        feats[:, spectra.shape[1]:] = np.round(feats[:, spectra.shape[1]:])
    elif knn_store_per_class is not None:
        keep = []
        for ci in range(len(codebook)):
            rows = np.where(labels == ci)[0][:knn_store_per_class]
            keep.append(rows)
        keep = np.concatenate(keep)
        feats = feats[keep]
        labels = labels[keep]
    return codebook, feats, labels


def train_classifier(
    generator: torch.Generator,
    layout: ChannelLayout,
    spectra: np.ndarray,
    code_strings: Sequence[str],
    check_bits: np.ndarray,
    cfg: ClassifierConfig = ClassifierConfig(),
    scaler: bool = False,
    violet_derivative: bool = False,
    full_derivative: bool = False,
    check_spectra: np.ndarray | None = None,
    check_bits_full: np.ndarray | None = None,
    knn_store_per_class: int | None = None,
    knn_prototypes_per_class: int | None | str = "auto",
    device=torch.device("cuda"),
    head_draws: tuple | None = None,
) -> ClassifierArrays:
    """Fit the classifier to simulated spectra (N, C[+derivative]) with
    their barcode strings and (N, n_checks) check bits: one check head per
    metric block on the (optionally standard-scaled) block columns of
    ``check_spectra`` (default ``spectra``; may hold negatives, with
    ``check_bits_full``), derivative blocks reading unscaled features, all
    trained on ``device`` (the card unless the caller names another) as
    one batched program; then the kNN matrix of ``knn_reference`` over the
    positives.

    The heads' initial parameters (``init_check_heads``) and one row
    permutation per head are drawn from ``generator``, which lives on
    ``device``, unless ``head_draws`` = (init dict, (H, n) perms) gives
    them. Training GEMMs run in float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spectra = np.asarray(spectra, np.float32)
    check_bits = np.asarray(check_bits, np.float32)
    if check_spectra is None:
        check_spectra = spectra
        check_bits_full = check_bits
    check_spectra = np.asarray(check_spectra, np.float32)
    check_bits_full = np.asarray(check_bits_full, np.float32)

    blocks, check_slice = metrics.metric_for_layout(layout, violet_derivative)
    n_channels = layout.n_channels
    if full_derivative:
        # the appended full-spectrum derivative is one extra ungated block
        blocks = tuple(blocks) + ((n_channels, 2 * n_channels - 1),)
        check_slice = (2 * n_channels - 1, 2 * n_channels - 1
                       + (check_slice[1] - check_slice[0]))

    scaler_mean = scaler_scale = None
    scaled = check_spectra[:, :n_channels]
    if scaler:
        scaler_mean = scaled.mean(axis=0)
        scaler_scale = scaled.std(axis=0) + 1e-12
        scaled = (scaled - scaler_mean) / scaler_scale

    # one head per metric block, its columns zero-padded to the widest
    # block's width
    n_heads = min(len(blocks), check_bits_full.shape[1])
    head_blocks = list(blocks[:n_heads])
    wmax = max(hi - lo for lo, hi in head_blocks)
    xs, ys = [], []
    for b, (lo, hi) in enumerate(head_blocks):
        x = scaled[:, lo:hi] if hi <= n_channels else check_spectra[:, lo:hi]
        xs.append(np.pad(x, ((0, 0), (0, wmax - (hi - lo)))))
        ys.append(check_bits_full[:, b])
    x = torch.from_numpy(np.stack(xs)).to(device)
    y = torch.from_numpy(np.stack(ys)).to(device)
    del xs, ys
    if head_draws is None:
        init = init_check_heads(generator, n_heads, wmax, cfg.check_hidden)
        perms = torch.stack([
            torch.randperm(x.shape[1], generator=generator, device=device)
            for _ in range(n_heads)])
    else:
        init, perms = head_draws
    params = train_check_heads(
        x, y, {k: torch.as_tensor(v).to(device) for k, v in init.items()},
        torch.as_tensor(perms).to(device), cfg.check_train_steps,
        cfg.check_lr)
    del x, y
    params = {k: v.cpu().numpy() for k, v in params.items()}
    check_params = [{k: params[k][b] for k in params}
                    for b in range(n_heads)]

    # the kNN matrix holds the positives only
    codebook, feats, labels = knn_reference(
        spectra, code_strings, check_bits, check_slice[1] - check_slice[0],
        knn_store_per_class, knn_prototypes_per_class)

    return ClassifierArrays(
        layout_name=layout.name,
        n_channels=n_channels,
        blocks=blocks,
        check_slice=check_slice,
        codebook=tuple(codebook),
        train_features=feats,
        train_labels=labels,
        check_params=tuple(check_params),
        check_blocks=tuple(head_blocks),
        scaler_mean=scaler_mean,
        scaler_scale=scaler_scale,
        n_neighbors=cfg.n_neighbors,
        temperature=cfg.knn_temperature,
        violet_derivative=violet_derivative,
        full_derivative=full_derivative,
    )
