"""Port parity: fast-mode NL-means (kernel B1's plain version) vs the JAX
package's XLA formulation on the CPU, whole frame, border included.

The inputs are smooth images: on uniform noise every off-centre weight
exp(-d^2/h^2) with h = 0.02 underflows to 0 and NLM returns its input, so
such a test would hold nothing about the weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import denoise as jdn
from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.ops import denoise as tdn

torch.set_num_threads(1)


def smooth_image(shape, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(yy / 17.0) * np.cos(xx / 23.0) \
        + 0.005 * rng.randn(*shape)
    return img.astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((96, 160), 0), ((70, 53), 1)])
def test_nlm_plain_matches_xla_whole_frame(shape, seed):
    img = smooth_image(shape, seed)
    ref = np.asarray(jdn.denoise_nl_means(jnp.asarray(img), 0.02, 7, 11))
    out = tdn.denoise_nl_means(torch.from_numpy(img), 0.02, 7, 11).numpy()
    # the weights are not trivial: the output moved away from the input
    assert np.abs(ref - img).max() > 1e-3
    # Same algorithm and op order, but the two libraries round the box
    # filter's running sums differently: ~1 ulp of a running sum near 0.5
    # (6e-8), / 49 / h^2 gives ~3e-6 relative in a weight, times a window
    # value spread of ~0.3 -> ~1e-6 in the output. atol 5e-6 covers it.
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-6)


def test_nlm_wrapper_takes_plain_version_on_cpu():
    img = torch.from_numpy(smooth_image((40, 48), 2))
    before = kernels.nlm.launches
    out = tdn.denoise_nl_means(img)
    assert kernels.nlm.launches == before
    torch.testing.assert_close(out, tdn.denoise_nl_means_plain(img),
                               rtol=0, atol=0)


def test_half_offsets_match_reference_scan_order():
    offs = tdn.half_offsets(11)
    assert len(offs) == 264
    assert offs[0] == (0, 1) and offs[-1] == (11, 11)
    assert all(o > (0, 0) for o in offs) and offs == sorted(offs)
