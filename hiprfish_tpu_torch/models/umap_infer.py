"""The reference's legacy UMAP classifier stacks on the card (the port of
hiprfish_tpu/models/umap_infer.py).

The reference classifies with joblib pickles: a fitted ``umap.UMAP``
(``*_umap_transform.pkl``), an RBF SVC over its 2-D embedding and per-laser
check SVCs (and, for 7-bit, a StandardScaler). At inference it sets the
check-bit columns from the check SVCs, embeds the features with
``umap_transform.transform`` and calls the codes with the embedded SVC.

* ``load_umap_pickle`` reads the arrays the transform needs from the
  pickle through models/legacy_pickle.py (no umap-learn, joblib or numba).
* ``umap_transform`` is the JAX package's transform step for step: an exact
  kNN under the artifact's metric (chunks of reference rows, merged by a
  stable sort, so ties go to the lower index as ``lax.top_k`` gives them),
  the smooth-kNN calibration (64 bisection steps), initialisation at the
  weight-normalised mean of the neighbours' embeddings, then ``n_epochs``
  of clipped attractive steps weighted by w / w_max and clipped repulsive
  means over random training points, against the frozen embedding. The
  weights and the layout run in float64 (the embedding is returned in
  float32), so the CPU and the card give the same embedding. The random
  draws are an input (``negatives``) or come from an explicit generator.
* ``LegacyUmapClassifier`` and ``load_legacy_umap_stack(_7b)`` hold and
  load a whole stack by the reference's file names.

The metric GEMMs sum in float64 (models/metrics.py), so the neighbours
are the same on every device.
"""

from __future__ import annotations

import re
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from hiprfish_tpu_torch.models import metrics
from hiprfish_tpu_torch.models.artifacts import load_reference_svc
from hiprfish_tpu_torch.models.legacy_pickle import get_attr, permissive_load
from hiprfish_tpu_torch.utils.logging import stage_timer

# reference rows per distance block of the kNN: (Q, 2^18) float32
# temporaries stay within a few GB at Q ~ 400 cells
KNN_CHUNK_ROWS = 1 << 18


class UmapModel(NamedTuple):
    raw_data: np.ndarray     # (N, D) training features
    embedding: np.ndarray    # (N, E) fitted embedding (frozen at transform)
    a: float                 # output-curve coefficient
    b: float                 # output-curve coefficient
    n_neighbors: int
    metric: str              # metric name recorded in the artifact


def load_umap_pickle(path: str) -> UmapModel:
    """The transform's arrays of a pickled fitted UMAP (plain pickle or
    joblib), read without umap-learn: _raw_data, embedding_, _a and _b
    (1.577, 0.8951 where absent), n_neighbors (15 where absent) and the
    metric's name (a numba dispatcher pickled by reference gives its
    function's name)."""
    obj = permissive_load(path)
    raw = get_attr(obj, "_raw_data", "raw_data")
    emb = get_attr(obj, "embedding_", "embedding")
    if raw is None or emb is None:
        raise ValueError(
            f"{path} does not look like a fitted UMAP artifact "
            f"(missing _raw_data/embedding_); got {type(obj)!r}")
    a = get_attr(obj, "_a", "a")
    b = get_attr(obj, "_b", "b")
    if a is None or b is None:
        # umap's fitted defaults for min_dist=0.1, spread=1.0
        a, b = 1.577, 0.8951
    metric = get_attr(obj, "metric", default="euclidean")
    if not isinstance(metric, str):
        metric = getattr(metric, "__name__", None) \
            or getattr(type(metric), "__name__", "euclidean")
    return UmapModel(
        raw_data=np.asarray(raw, np.float32),
        embedding=np.asarray(emb, np.float32),
        a=float(a), b=float(b),
        n_neighbors=int(get_attr(obj, "n_neighbors", default=15) or 15),
        metric=str(metric))


def _euclidean_distance_matrix(x, y):
    """sqrt(max(x2 + y2 - 2 x.y, 0)) in float64 with its sums in column
    order (models/metrics._products64), rounded once: the same bits on
    every device."""
    d2 = (metrics._sumsq64(x)[:, None] + metrics._sumsq64(y)[None, :]
          - 2.0 * metrics._products64(x, y))
    return torch.sqrt(torch.clamp(d2, min=0.0)).float()


def knn(x: torch.Tensor, y: torch.Tensor, k: int,
        distance_fn: Callable | None = None,
        chunk_rows: int = KNN_CHUNK_ROWS):
    """(distances, indices), each (Q, k), of the k nearest reference rows
    of ``y`` under ``distance_fn`` (Euclidean when None), ascending, ties
    to the lower index. The distances are taken ``chunk_rows`` reference
    rows at a time; each chunk's candidates follow the running best (all
    of lower index) and one stable sort keeps the first k."""
    fn = distance_fn or _euclidean_distance_matrix
    best_d = best_i = None
    for lo in range(0, y.shape[0], chunk_rows):
        d = fn(x, y[lo:lo + chunk_rows])
        idx = torch.arange(lo, lo + d.shape[1], device=d.device) \
            .expand(d.shape[0], -1)
        if best_d is not None:
            d = torch.cat([best_d, d], dim=1)
            idx = torch.cat([best_i, idx], dim=1)
        d, order = torch.sort(d, dim=1, stable=True)
        best_d = d[:, :k].contiguous()
        best_i = torch.gather(idx, 1, order[:, :k])
        del d, idx, order
    return best_d, best_i


def _smooth_knn_weights(knn_d: torch.Tensor, n_neighbors: int,
                        n_iter: int = 64, local_connectivity: float = 1.0,
                        bandwidth: float = 1.0) -> torch.Tensor:
    """umap.smooth_knn_dist's rho and sigma, then the membership
    strengths, for (Q, k) ascending neighbour distances: rho the smallest
    nonzero distance, sigma by bisection towards log2(k) (mid doubles while
    hi is infinite), floored at 1e-3 x the mean of all the distances."""
    like = dict(dtype=knn_d.dtype, device=knn_d.device)
    target = torch.log2(torch.tensor(float(n_neighbors), **like)) * bandwidth
    inf = torch.full_like(knn_d, float("inf"))
    nz = torch.where(knn_d > 0.0, knn_d, inf)
    idx = int(np.ceil(local_connectivity)) - 1
    rho = torch.sort(nz, dim=1).values[:, idx]
    rho = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))
    z = torch.clamp(knn_d - rho[:, None], min=0.0)
    q = knn_d.shape[0]
    lo = torch.zeros(q, **like)
    hi = torch.full((q,), float("inf"), **like)
    mid = torch.ones(q, **like)
    for _ in range(n_iter):
        val = torch.sum(torch.exp(-z / mid[:, None]), dim=1)
        too_big = val > target
        hi = torch.where(too_big, mid, hi)
        lo = torch.where(too_big, lo, mid)
        mid = torch.where(too_big, (lo + hi) / 2.0,
                          torch.where(torch.isinf(hi), mid * 2.0,
                                      (lo + hi) / 2.0))
    sigma = torch.maximum(mid, 1e-3 * torch.mean(knn_d))
    return torch.exp(-z / sigma[:, None])


def transform_full(model: UmapModel, query,
                   distance_fn: Callable | None = None, n_epochs: int = 30, initial_alpha: float = 1.0,
                   negative_sample_rate: int = 5,
                   generator: torch.Generator | None = None,
                   negatives: torch.Tensor | None = None,
                   device=torch.device("cuda"), timings: dict | None = None):
    """umap_transform's (embedding (Q, E), neighbour indices (Q, k),
    neighbour distances (Q, k)); ``timings`` receives the seconds of
    "distance and top-k", "weights" and "epochs"."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    lap = stage_timer(timings, device)
    if not isinstance(query, torch.Tensor):
        query = torch.from_numpy(np.asarray(query, np.float32))
    x = query.to(device, torch.float32)
    y = torch.as_tensor(model.raw_data, dtype=torch.float32, device=device)
    train_emb = torch.as_tensor(model.embedding, dtype=torch.float32,
                                device=device)
    q, n_train = x.shape[0], y.shape[0]
    n_neg = int(negative_sample_rate)
    k = min(model.n_neighbors, n_train)
    knn_d, knn_idx = knn(x, y, k, distance_fn)
    del y
    lap("distance and top-k")

    # the weights and the layout in float64: the float32 layout steps
    # amplify one-ulp differences (pow, exp, sum order) by up to ~7x per
    # epoch on tight clusters, so in float32 the CPU and the card would
    # end ~1e-3 apart; in float64 they agree far below float32's ulp
    w = _smooth_knn_weights(knn_d.double(), k)
    wn = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
    train_emb = train_emb.double()
    nbr_emb = train_emb[knn_idx]                          # (Q, k, E)
    emb = torch.sum(wn[:, :, None] * nbr_emb, dim=1)
    edge_w = w / torch.clamp(torch.max(w), min=1e-12)
    lap("weights")

    if negatives is not None:
        negatives = torch.as_tensor(negatives, device=device)
        if tuple(negatives.shape) != (n_epochs, q, n_neg):
            raise ValueError(f"negatives: shape {tuple(negatives.shape)}, "
                             f"expected {(n_epochs, q, n_neg)}")
    elif generator is None:
        generator = torch.Generator(device).manual_seed(0)
    # a, b and alpha take the reference's float32 values
    ab = torch.tensor([model.a, model.b], dtype=torch.float32,
                      device=device).double()
    a, b = ab[0], ab[1]
    for e in range(n_epochs):
        alpha = float(np.float32(initial_alpha) * (
            np.float32(1.0) - np.float32(e) / np.float32(n_epochs)))
        # attractive steps towards every kNN edge, weighted by w / w_max
        diff = emb[:, None, :] - nbr_emb
        d2 = torch.clamp(torch.sum(diff * diff, dim=-1), min=1e-12)
        coeff = (-2.0 * a * b * torch.pow(d2, b - 1.0)
                 / (1.0 + a * torch.pow(d2, b)))
        grad = torch.clamp(coeff[:, :, None] * diff, -4.0, 4.0)
        emb = emb + alpha * torch.sum(edge_w[:, :, None] * grad, dim=1)
        # repulsive steps from random training points
        neg_idx = negatives[e] if negatives is not None else torch.randint(
            0, n_train, (q, n_neg), generator=generator, device=device)
        diffn = emb[:, None, :] - train_emb[neg_idx]
        d2n = torch.sum(diffn * diffn, dim=-1)
        coeffn = (2.0 * b / ((0.001 + d2n)
                             * (1.0 + a * torch.pow(
                                 torch.clamp(d2n, min=1e-12), b))))
        gradn = torch.clamp(coeffn[:, :, None] * diffn, -4.0, 4.0)
        emb = emb + alpha * torch.mean(gradn, dim=1)
    lap("epochs")
    return emb.float(), knn_idx, knn_d


def umap_transform(model: UmapModel, query,
                   distance_fn: Callable | None = None, n_epochs: int = 30,
                   initial_alpha: float = 1.0, negative_sample_rate: int = 5,
                   generator: torch.Generator | None = None,
                   negatives: torch.Tensor | None = None,
                   device=torch.device("cuda"),
                   timings: dict | None = None) -> torch.Tensor:
    """Embed ``query`` (Q, D) into a fitted UMAP's space: (Q, E) on
    ``device``. ``distance_fn(query, reference_rows) -> (Q, n)`` must be
    the metric the model was fitted with (Euclidean when None; see
    ``resolve_metric_fn``). The repulsive draws are ``negatives``
    ((n_epochs, Q, negative_sample_rate) int64 indices into the training
    rows) or, without them, one torch.randint per epoch from
    ``generator`` (a fresh generator on ``device`` seeded 0 when None)."""
    return transform_full(model, query, distance_fn, n_epochs,
                          initial_alpha, negative_sample_rate, generator,
                          negatives, device, timings)[0]


def resolve_metric_fn(model: UmapModel, distance_fn: Callable | None):
    """The distance function of a loaded UMAP: ``distance_fn`` when
    given, None (Euclidean) for "euclidean" or "l2", else the reference
    metric of that name (models/metrics.reference_metric_matrix); any
    other recorded metric is an error, since scoring under the wrong
    metric reorders neighbours."""
    if distance_fn is not None:
        return distance_fn
    name = model.metric
    if name in ("euclidean", "l2"):
        return None
    try:
        return metrics.reference_metric_matrix(name)
    except KeyError:
        raise ValueError(
            f"UMAP artifact was fitted with metric {name!r}, which has no "
            "matrix form (models/metrics.py:reference_metric_matrix); pass "
            "distance_fn= explicitly to override") from None


class LegacyUmapClassifier(NamedTuple):
    """The reference's pickled classifier stack on ``device``: the check
    SVCs fill the check-bit columns (the last ones), the UMAP embeds the
    features, the embedded SVC calls the codes. With a StandardScaler
    (7-bit), the check SVCs see the scaled base columns; the UMAP sees the
    unscaled features with the predicted bits."""

    umap: UmapModel
    svc_embed: "object"                  # TorchRbfSvc over the embedding
    check_svcs: Sequence["object"]       # per-laser-block TorchRbfSvc list
    blocks: Sequence[tuple]              # feature slices per check SVC
    distance_fn: Callable | None = None
    scaler_mean: torch.Tensor | None = None     # StandardScaler (7-bit)
    scaler_scale: torch.Tensor | None = None
    n_base: int | None = None            # spectral columns the scaler covers
    device: torch.device = torch.device("cuda")

    def check_inputs(self, x: torch.Tensor) -> torch.Tensor:
        if self.scaler_mean is None:
            return x
        base = x[:, : self.n_base]
        scaled = (base - self.scaler_mean) / self.scaler_scale
        return torch.cat([scaled, x[:, self.n_base:]], dim=1)

    def predict(self, features, n_epochs: int = 30,
                generator: torch.Generator | None = None,
                return_checks: bool = False,
                negatives: torch.Tensor | None = None,
                timings: dict | None = None):
        """Barcode strings for the (Q, D) feature rows (their last
        len(check_svcs) columns are overwritten by the check bits); with
        ``return_checks`` also the float32 features with those bits.
        ``timings`` receives the seconds of "check SVCs", the transform's
        stages and "SVC"."""
        lap = stage_timer(timings, self.device)
        x = torch.from_numpy(np.array(features, np.float32)).to(self.device)
        base = x.shape[1] - len(self.check_svcs)
        xs = self.check_inputs(x)
        for i, (svc, (lo, hi)) in enumerate(zip(self.check_svcs,
                                                self.blocks)):
            bits = np.asarray(svc.predict(xs[:, lo:hi])).astype(np.float32)
            x[:, base + i] = torch.from_numpy(bits).to(self.device)
        lap("check SVCs")
        emb = umap_transform(self.umap, x, self.distance_fn, n_epochs,
                             generator=generator, negatives=negatives,
                             device=self.device, timings=timings)
        lap = stage_timer(timings, self.device)
        pred = self.svc_embed.predict(emb)
        lap("SVC")
        if return_checks:
            return pred, x.cpu().numpy()
        return pred


def load_legacy_umap_stack(transform_path: str,
                           blocks: Sequence[tuple] | None = None,
                           distance_fn: Callable | None = None,
                           device=torch.device("cuda")
                           ) -> LegacyUmapClassifier:
    """The reference's umap_transform / transformed_svc /
    transformed_check_svc pickles, by its file names; ``blocks`` defaults
    to the 10-bit + violet-derivative layout's six check blocks."""
    device = torch.device(device)
    svc_path = re.sub("transform.pkl", "transformed_svc.pkl", transform_path)
    check_path = re.sub("transform.pkl", "transformed_check_svc.pkl",
                        transform_path)
    umap_model = load_umap_pickle(transform_path)
    svc = load_reference_svc(svc_path, device)
    checks = load_reference_svc(check_path, device)
    if not isinstance(checks, list):
        checks = [checks]
    if blocks is None:
        blocks = [(0, 32), (32, 55), (55, 75), (75, 89), (89, 95), (95, 126)]
    return LegacyUmapClassifier(umap_model, svc, checks, tuple(blocks),
                                resolve_metric_fn(umap_model, distance_fn),
                                device=device)


def load_legacy_umap_stack_7b(transform_path: str,
                              distance_fn: Callable | None = None,
                              device=torch.device("cuda")
                              ) -> LegacyUmapClassifier:
    """The 7-bit pickles (umap transform, scaler, embedded SVC, four check
    SVCs over the scaled 63-channel blocks), by the reference's file
    names."""
    device = torch.device(device)

    def sub(tail):
        return re.sub("transform_biofilm_7b.pkl", tail, transform_path)

    umap_model = load_umap_pickle(transform_path)
    scaler = permissive_load(sub("transformed_biofilm_7b_scaler.pkl"))
    svc = load_reference_svc(sub("transformed_biofilm_7b_svc.pkl"), device)
    checks = load_reference_svc(sub("transformed_biofilm_7b_check_svc.pkl"),
                                device)
    if not isinstance(checks, list):
        checks = [checks]

    def param(name):
        return torch.from_numpy(np.asarray(get_attr(scaler, name),
                                           np.float32)).to(device)

    return LegacyUmapClassifier(
        umap_model, svc, checks, ((0, 23), (23, 43), (43, 57), (57, 63)),
        resolve_metric_fn(umap_model, distance_fn),
        scaler_mean=param("mean_"), scaler_scale=param("scale_"), n_base=63,
        device=device)
