"""Port parity: histogram-Lloyd KMeans masks vs the JAX package on the CPU.

768 x 768 = 589,824 values exceed 2^19, so the strided block subsample of
the histogram runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import kmeans as jkm
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


@pytest.mark.parametrize("shape", [(768, 768), (96, 128)])
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

