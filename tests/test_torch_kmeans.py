"""Port parity: histogram-Lloyd KMeans masks vs the JAX package on the CPU.

768 x 768 = 589,824 values exceed 2^19, so the strided block subsample of
the histogram runs. The card's fixed-point bin sums are held here to their
order-freedom and to f64 sums (the CPU path keeps sequential f32 sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import kmeans as jkm
from hiprfish_tpu_torch.ops import fp
from hiprfish_tpu_torch.ops import kmeans as tkm

torch.set_num_threads(1)



def _bimodal(shape, seed):
    rng = np.random.RandomState(seed)
    img = rng.gamma(2.0, 0.05, shape).astype(np.float32)
    n = shape[0] * shape[1] // 20
    rows = rng.randint(0, shape[0], n)
    cols = rng.randint(0, shape[1], n)
    img[rows, cols] += rng.normal(0.8, 0.1, n).astype(np.float32)
    return img


@pytest.mark.parametrize("shape", [(768, 768), (256, 256), (96, 128)])
def test_brightest_cluster_mask_equal(shape):
    img = _bimodal(shape, 0)
    ref = np.asarray(jkm.brightest_cluster_mask(jnp.asarray(img), 2, 40))
    out = tkm.brightest_cluster_mask(torch.from_numpy(img), 2, 40).numpy()
    assert 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("k", [2, 3])
def test_kmeans1d_centers_close(k):
    img = _bimodal((300, 400), 1)
    ref = np.asarray(jkm.kmeans1d_centers(jnp.asarray(img), k, 40))
    out = tkm.kmeans1d_centers(torch.from_numpy(img), k, 40).numpy()
    # bin sums are sequential on both sides; only the Lloyd reductions'
    # summation order differs
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def _bins(n, seed, n_bins=2048):
    v = torch.from_numpy(_bimodal((n // 64, 64), seed).reshape(-1))
    vmin, vmax = v.min(), v.max()
    span = torch.clamp(vmax - vmin, min=1e-12)
    idx = torch.clamp(((v - vmin) / span * (n_bins - 1)).to(torch.int32), 0,
                      n_bins - 1)
    return idx, v, vmin, span


def _bin_sums(idx, v, vmin, span, n_bins=2048):
    """The card's histogram bin sums, as kmeans._value_histogram asks
    fp.segment_sum for them on CUDA."""
    counts, sums = fp.fixed_point_sums(v[:, None], idx, n_bins, span=span,
                                       offset=vmin, bits=tkm.FIX_BITS)
    return counts, sums[:, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_point_bin_sums_are_order_free(seed):
    idx, v, vmin, span = _bins(1 << 16, seed)
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(v.numel()))
    counts, sums = _bin_sums(idx, v, vmin, span)
    c2, s2 = _bin_sums(idx[perm], v[perm], vmin, span)
    assert torch.equal(counts, c2) and torch.equal(sums, s2)
    assert int(counts.sum()) == v.numel()


@pytest.mark.parametrize("seed", [0, 3])
def test_fixed_point_bin_sums_close_to_f64(seed):
    idx, v, vmin, span = _bins(1 << 16, seed)
    counts, sums = _bin_sums(idx, v, vmin, span)
    ref = torch.zeros(2048, dtype=torch.float64).index_add_(
        0, idx, v.to(torch.float64))
    n = torch.zeros(2048, dtype=torch.float64).index_add_(
        0, idx, torch.ones_like(v, dtype=torch.float64))
    torch.testing.assert_close(counts.to(torch.float64), n, rtol=0, atol=0)
    # each offset rounds to span * 2^-40 (count * span * 2^-41 per bin),
    # then the bin's sum rounds once to f32 (2^-24 relative)
    tol = 2.0 ** -24 * ref.abs() + n * float(span) * 2.0 ** -41
    assert bool(((sums.to(torch.float64) - ref).abs() <= tol).all())
