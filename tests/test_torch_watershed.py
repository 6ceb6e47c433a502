"""Port parity: marker watershed vs the JAX package on the CPU, labels
bitwise equal, on surfaces with plateaus (where the tie rule decides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import watershed as jws
from hiprfish_tpu_torch.ops import watershed as tws

torch.set_num_threads(1)


def _case(seed, quantize):
    rng = np.random.RandomState(seed)
    h, w = 64, 96
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    surf = np.zeros((h, w), np.float32)
    markers = np.zeros((h, w), np.int32)
    for i in range(8):
        cy, cx = rng.uniform(6, h - 6), rng.uniform(6, w - 6)
        surf -= np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 60.0)
        markers[int(cy), int(cx)] = i + 1
    if quantize:
        surf = np.round(surf * 4) / 4      # wide plateaus: ties everywhere
    mask = surf < -0.05 if quantize else surf < -0.02
    return surf.astype(np.float32), markers, mask


@pytest.mark.parametrize("seed,quantize", [(0, True), (1, True), (2, False)])
def test_watershed_bitwise_equal(seed, quantize):
    surf, markers, mask = _case(seed, quantize)
    ref = np.asarray(jws.watershed(jnp.asarray(surf), jnp.asarray(markers),
                                   jnp.asarray(mask), 1, 256))
    out = tws.watershed(torch.from_numpy(surf), torch.from_numpy(markers),
                        torch.from_numpy(mask), 1, 256)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) > 3


def test_watershed_iteration_cap_matches_reference():
    surf, markers, mask = _case(3, True)
    ref = np.asarray(jws.watershed(jnp.asarray(surf), jnp.asarray(markers),
                                   jnp.asarray(mask), 1, 3))
    out = tws.watershed(torch.from_numpy(surf), torch.from_numpy(markers),
                        torch.from_numpy(mask), 1, 3).numpy()
    np.testing.assert_array_equal(out, ref)
