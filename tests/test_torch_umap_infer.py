"""Port parity for the legacy UMAP transform and the reference metrics
(hiprfish_tpu_torch/models/umap_infer.py, models/metrics.py) against the
JAX package on the same numpy inputs:

- the seven reference metrics, block_chi_distance_matrix and
  correlation_distance_matrix within 2e-6 (tests/test_reference_metrics.py's
  cases: zero blocks, forced check agreements);
- resolve_metric_fn's three outcomes;
- _smooth_knn_weights within 1e-6;
- umap_transform with the JAX key chain's negative draws fed in: equal
  neighbour indices (on a tie-heavy fixture too, where most neighbours sit
  at exactly 1.0) and embeddings within 1e-4; the chunked kNN equal to one
  chunk; the generator path reproducible;
- the 7-bit stack's scaled check inputs bitwise equal to the JAX
  package's numpy ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.models import metrics as jmetrics
from hiprfish_tpu.models import umap_infer as jumap
from hiprfish_tpu_torch.models import metrics, umap_infer
from tests.test_reference_metrics import CASES, _random_features

torch.set_num_threads(1)

NAMES = [c[0] for c in CASES] + ["channel_cosine_intensity_normal",
                                 "channel_chi_intensity_7b",
                                 "channel_correlation"]
WIDTH = {c[0]: (c[1], c[3]) for c in CASES}
WIDTH.update({"channel_cosine_intensity_normal": (100, (95, 100)),
              "channel_chi_intensity_7b": (67, (63, 67)),
              "channel_correlation": (67, (63, 67))})


def jax_negatives(n_epochs, q, n_neg, n_train, key=None):
    """The draws of hiprfish_tpu.models.umap_infer._transform_impl: per
    epoch key, sub = split(key), then randint(sub, (q, n_neg), 0, n)."""
    key = jax.random.PRNGKey(0) if key is None else key
    out = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (q, n_neg), 0,
                                                 n_train)))
    return np.stack(out).astype(np.int64)


def _pair(name, seed):
    d, cs = WIDTH[name]
    rng = np.random.RandomState(seed)
    q = _random_features(rng, 12, d, cs, 5)
    r = _random_features(rng, 17, d, cs, 5)
    r[:6, cs[0]:cs[1]] = q[:6, cs[0]:cs[1]]
    return q, r


@pytest.mark.parametrize("name", NAMES)
def test_reference_metric_matches_jax(name):
    q, r = _pair(name, 3)
    want = np.asarray(jmetrics.reference_metric_matrix(name)(q, r))
    got = metrics.reference_metric_matrix(name)(torch.from_numpy(q),
                                                torch.from_numpy(r))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("which", ["block_chi", "correlation"])
def test_chi_and_correlation_matrices_match_jax(which):
    q, r = _pair("channel_chi_intensity_7b", 5)
    blocks = jmetrics._REF_BLOCKS_7B
    if which == "block_chi":
        want = jmetrics.block_chi_distance_matrix(q, r, blocks)
        got = metrics.block_chi_distance_matrix(
            torch.from_numpy(q), torch.from_numpy(r), blocks)
    else:
        want = jmetrics.correlation_distance_matrix(q, r)
        got = metrics.correlation_distance_matrix(torch.from_numpy(q),
                                                  torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_resolve_metric_fn_outcomes():
    model = umap_infer.UmapModel(
        raw_data=np.zeros((4, 67), np.float32),
        embedding=np.zeros((4, 2), np.float32), a=1.6, b=0.9, n_neighbors=3,
        metric="channel_cosine_intensity_7b_v2")
    q, r = _pair("channel_cosine_intensity_7b_v2", 1)
    fn = umap_infer.resolve_metric_fn(model, None)
    np.testing.assert_array_equal(
        fn(torch.from_numpy(q), torch.from_numpy(r)).numpy(),
        metrics.reference_metric_matrix(model.metric)(
            torch.from_numpy(q), torch.from_numpy(r)).numpy())
    for name in ("euclidean", "l2"):
        assert umap_infer.resolve_metric_fn(
            model._replace(metric=name), None) is None
    with pytest.raises(ValueError, match="mahalanobis"):
        umap_infer.resolve_metric_fn(model._replace(metric="mahalanobis"),
                                     None)
    with pytest.raises(KeyError):
        metrics.reference_metric_matrix("mahalanobis")
    own = metrics.correlation_distance_matrix
    assert umap_infer.resolve_metric_fn(
        model._replace(metric="mahalanobis"), own) is own


def test_smooth_knn_weights_match_jax():
    rng = np.random.RandomState(7)
    d = np.sort(rng.rand(40, 15).astype(np.float32) * 2, axis=1)
    d[:5, :3] = 0.0                      # rho skips exact zeros
    d[5] = 0.0                           # no nonzero neighbour: rho 0
    d[6] = 1.0                           # all tied
    want = np.asarray(jumap._smooth_knn_weights(jnp.asarray(d), 15))
    got = umap_infer._smooth_knn_weights(torch.from_numpy(d), 15).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _clustered(seed, n_classes=8, per=30, dim=20):
    rng = np.random.RandomState(seed)
    centers = rng.rand(n_classes, dim).astype(np.float32) + 0.2
    y = np.repeat(np.arange(n_classes), per)
    x = np.clip(centers[y] + rng.randn(len(y), dim).astype(np.float32)
                * 0.05, 0, None)
    ang = 2 * np.pi * y / n_classes
    emb = (np.stack([10 * np.cos(ang), 10 * np.sin(ang)], 1)
           + rng.randn(len(y), 2) * 0.3).astype(np.float32)
    qy = np.repeat(np.arange(n_classes), 4)
    q = np.clip(centers[qy] + rng.randn(len(qy), dim).astype(np.float32)
                * 0.05, 0, None)
    return x, emb, q


def _tie_heavy(seed):
    """67-column rows (63 channels, 4 check bits) under the 7b_v2 metric:
    each query's check pattern is shared by fewer than k training rows, so
    its later neighbours all sit at exactly 1.0."""
    rng = np.random.RandomState(seed)
    x = rng.rand(60, 67).astype(np.float32)
    x[:, 63:] = (rng.rand(60, 4) > 0.5).astype(np.float32)
    emb = (rng.randn(60, 2) * 3).astype(np.float32)
    q = rng.rand(10, 67).astype(np.float32)
    q[:, 63:] = x[rng.randint(0, 60, 10), 63:]
    return x, emb, q


def _jax_transform(jmodel, q, n_epochs):
    jfn = jumap.resolve_metric_fn(jmodel, None)
    x = jnp.asarray(jmodel.raw_data)
    dmat = (jfn(jnp.asarray(q), x) if jfn is not None else
            jumap._euclidean_distance_matrix(jnp.asarray(q), x))
    return [np.asarray(v) for v in jumap._transform_impl(
        dmat, jnp.asarray(jmodel.embedding), jax.random.PRNGKey(0),
        jnp.asarray([1.577, 0.8951], jnp.float32), jmodel.n_neighbors,
        n_epochs, 1.0, 5)]


@pytest.mark.parametrize("case", ["clusters", "tie_heavy"])
def test_transform_matches_jax_with_its_draws(case):
    """Equal neighbours; the embeddings within 1e-4 where the layout
    contracts (tie_heavy: neighbours spread over the embedding). On tight
    clusters the first epochs' attractive step (alpha near 1, slope ~1 per
    neighbour at r ~ 0.4) overshoots, so the JAX package's float32
    roundings (against the port's float64 layout) grow by up to ~7x per
    epoch: there one epoch from JAX's own distances is held to 1e-4, and
    30 epochs to the same nearest cluster and 0.05."""
    if case == "clusters":
        x, emb, q = _clustered(0)
        metric = "euclidean"
    else:
        x, emb, q = _tie_heavy(1)
        metric = "channel_cosine_intensity_7b_v2"
    model = umap_infer.UmapModel(x, emb, 1.577, 0.8951, 15, metric)
    jmodel = jumap.UmapModel(x, emb, 1.577, 0.8951, 15, metric)
    fn = umap_infer.resolve_metric_fn(model, None)
    for n_epochs in (1, 30):
        j_emb, j_idx, j_d = _jax_transform(jmodel, q, n_epochs)
        negs = jax_negatives(n_epochs, q.shape[0], 5, x.shape[0])
        emb_t, idx_t, d_t = umap_infer.transform_full(
            model, q, fn, n_epochs, negatives=torch.from_numpy(negs),
            device="cpu")
        np.testing.assert_array_equal(idx_t.numpy(), j_idx)
        # the Euclidean GEMM form sqrt(x2 + y2 - 2 x.y) loses ~1e-5 to
        # cancellation where the packages sum in other orders
        np.testing.assert_allclose(d_t.numpy(), j_d, rtol=0,
                                   atol=2e-6 if case == "tie_heavy" else 5e-5)
        err = np.abs(emb_t.numpy() - j_emb).max()
        if case == "tie_heavy":
            assert err <= 1e-4, (n_epochs, err)
        elif n_epochs == 1:
            # the one step from JAX's own distances: the distances' 1e-5
            # move the weights, which the step amplifies
            dmat = torch.from_numpy(np.asarray(
                jumap._euclidean_distance_matrix(jnp.asarray(q),
                                                 jnp.asarray(x))))
            emb_j = umap_infer.umap_transform(
                model, q, lambda a, b: dmat[:, :b.shape[0]], 1,
                negatives=negs, device="cpu").numpy()
            assert np.abs(emb_j - j_emb).max() <= 1e-4
        else:
            assert err < 0.05, err
            cents = np.stack([emb[i * 30:(i + 1) * 30].mean(0)
                              for i in range(8)])
            near = [np.linalg.norm(e[:, None] - cents[None], axis=2)
                    .argmin(1) for e in (emb_t.numpy(), j_emb)]
            np.testing.assert_array_equal(near[0], near[1])
            np.testing.assert_array_equal(near[0], np.repeat(np.arange(8),
                                                             4))
    if case == "tie_heavy":
        # most rows' k-th neighbour is a tie at exactly 1.0
        assert (d_t[:, -1] == 1.0).float().mean() >= 0.8
        # the public entry points, the JAX one with its key=None draws
        want = np.asarray(jumap.umap_transform(
            jmodel, q, distance_fn=jumap.resolve_metric_fn(jmodel, None)))
        got = umap_infer.umap_transform(model, q, fn, negatives=negs,
                                        device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_chunked_knn_equals_one_chunk():
    x, _, q = _tie_heavy(2)
    fn = metrics.reference_metric_matrix("channel_cosine_intensity_7b_v2")
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    d1, i1 = umap_infer.knn(qt, xt, 12, fn)
    for chunk in (7, 12, 13, 59):
        d2, i2 = umap_infer.knn(qt, xt, 12, fn, chunk_rows=chunk)
        np.testing.assert_array_equal(i2.numpy(), i1.numpy())
        np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=0,
                                   atol=1e-7)


def test_generator_draws_are_reproducible():
    x, emb, q = _clustered(3)
    model = umap_infer.UmapModel(x, emb, 1.577, 0.8951, 15, "euclidean")
    a = umap_infer.umap_transform(model, q, device="cpu")
    b = umap_infer.umap_transform(
        model, q, generator=torch.Generator("cpu").manual_seed(0),
        device="cpu")
    c = umap_infer.umap_transform(
        model, q, generator=torch.Generator("cpu").manual_seed(1),
        device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="negatives"):
        umap_infer.umap_transform(model, q, negatives=np.zeros(
            (29, q.shape[0], 5), np.int64), device="cpu")


def test_scaled_check_inputs_match_jax():
    rng = np.random.RandomState(8)
    x = rng.rand(9, 67).astype(np.float32)
    mean = rng.rand(63).astype(np.float32)
    scale = rng.rand(63).astype(np.float32) + 0.5
    jstack = jumap.LegacyUmapClassifier(None, None, [], (), None, mean,
                                        scale, 63)
    stack = umap_infer.LegacyUmapClassifier(
        None, None, [], (), None, torch.from_numpy(mean),
        torch.from_numpy(scale), 63, torch.device("cpu"))
    assert stack.check_inputs(torch.from_numpy(x)).numpy().tobytes() \
        == jstack.check_inputs(x).tobytes()
