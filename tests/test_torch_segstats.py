"""Port parity: per-label stats (kernel B3's plain version) and per-pixel
lookup (kernel B4's plain version) vs the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import segstats as jseg
from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.ops import segstats as tseg

torch.set_num_threads(1)

NSEG = 96


def _labels(shape, seed, n=60):
    """Raster-ordered blocky labels 1..n with background, touching the
    border (band-local, like ranked cells)."""
    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int32)
    nid = 0
    for r in range(0, shape[0], 8):
        for c in range(0, shape[1], 12):
            nid += 1
            if nid > n:
                return lab
            if rng.rand() < 0.8:
                h, w = rng.randint(3, 8), rng.randint(4, 12)
                lab[r:r + h, c:c + w] = nid
    return lab


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_label_stats_counts_border_sums(dtype):
    rng = np.random.RandomState(0)
    lab = _labels((48, 80), 0)
    img = rng.rand(48, 80, 7).astype(np.float32)
    jimg = jnp.asarray(img).astype(getattr(jnp, dtype))
    timg = torch.from_numpy(img).to(getattr(torch, dtype))
    ref = jseg.label_stats(jnp.asarray(lab), jimg, NSEG)
    out = tseg.label_stats(torch.from_numpy(lab), timg, NSEG)
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.border_hits.numpy(),
                                  np.asarray(ref.border_hits))
    assert np.asarray(ref.border_hits).sum() > 0
    np.testing.assert_allclose(out.sums.numpy(), np.asarray(ref.sums),
                               rtol=1e-6, atol=1e-6)
    assert out.spill is False and out.moments is None


def test_label_stats_all_columns():
    rng = np.random.RandomState(1)
    lab = _labels((40, 72), 1)
    img = rng.rand(40, 72, 5).astype(np.float32)
    aux = rng.randint(0, 4, (40, 72)).astype(np.int32)
    mask = (rng.rand(40, 72) > 0.3).astype(np.float32)
    ref = jseg.label_stats(jnp.asarray(lab), jnp.asarray(img), NSEG,
                           aux=jnp.asarray(aux), aux_classes=4, moments=True,
                           image_mask=jnp.asarray(mask))
    out = tseg.label_stats(torch.from_numpy(lab), torch.from_numpy(img),
                           NSEG, aux=torch.from_numpy(aux), aux_classes=4,
                           moments=True, image_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.aux_hist.numpy(),
                                  np.asarray(ref.aux_hist))
    np.testing.assert_array_equal(out.mask_counts.numpy(),
                                  np.asarray(ref.mask_counts))
    np.testing.assert_allclose(out.moments.numpy(), np.asarray(ref.moments),
                               rtol=1e-6)
    np.testing.assert_allclose(out.sums.numpy(), np.asarray(ref.sums),
                               rtol=1e-6, atol=1e-6)


def test_label_stats_clips_ids_and_skips_label_zero():
    lab = np.array([[0, 1, 200], [2, 200, 0]], np.int32)
    st = tseg.label_stats(torch.from_numpy(lab), None, 8)
    np.testing.assert_array_equal(st.counts.numpy(),
                                  [0, 1, 1, 0, 0, 0, 0, 2])
    assert st.sums.shape == (8, 0)


def test_label_lookup_equal_including_label_zero():
    rng = np.random.RandomState(2)
    lab = _labels((48, 80), 2)
    assert (lab == 0).any()
    table = rng.rand(NSEG).astype(np.float32) + 1.0   # table[0] != 0
    ref = np.asarray(jseg.label_lookup(jnp.asarray(lab), jnp.asarray(table)))
    out = tseg.label_lookup(torch.from_numpy(lab),
                            torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[lab == 0] == 0.0).all()


def test_label_lookup_int_table_exact():
    lab = _labels((32, 48), 3)
    table = np.arange(NSEG, dtype=np.int32) * 3
    ref = np.asarray(jseg.label_lookup(jnp.asarray(lab), jnp.asarray(table)))
    out = tseg.label_lookup(torch.from_numpy(lab), torch.from_numpy(table))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_wrappers_take_plain_versions_on_cpu():
    lab = torch.from_numpy(_labels((16, 24), 4))
    before = kernels.launch_counts()
    tseg.label_stats(lab, None, NSEG)
    tseg.label_lookup(lab, torch.ones(NSEG))
    assert kernels.launch_counts() == before
