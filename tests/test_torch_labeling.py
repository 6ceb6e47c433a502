"""Port parity: CCL, ranking and binary morphology vs the JAX package on
the CPU (label images and masks must be equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import labeling as jlab
from hiprfish_tpu.ops import morphology as jmorph
from hiprfish_tpu.ops import segstats as jseg
from hiprfish_tpu_torch.ops import labeling as tlab
from hiprfish_tpu_torch.ops import morphology as tmorph
from hiprfish_tpu_torch.ops import segstats as tseg

torch.set_num_threads(1)


def _blobs(shape, seed, n=25, holes=True):
    """Random ellipses (some with holes) — snake-shaped and nested
    components exercise the scans' run caps and the fixpoint loop."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    m = np.zeros(shape, bool)
    for _ in range(n):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        a, b = rng.uniform(2, 9), rng.uniform(2, 20)
        th = rng.uniform(0, np.pi)
        u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
        v = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
        r2 = (u / b) ** 2 + (v / a) ** 2
        m |= r2 <= 1.0
        if holes and a > 5:
            m &= ~(r2 <= 0.15)
    # a serpentine component longer than any scan cap
    m[5, 3:90] = True
    m[5:40, 89] = True
    m[39, 10:90] = True
    return m


@pytest.mark.parametrize("connectivity,max_run", [(1, None), (2, None),
                                                  (2, 16), (1, 8)])
def test_label_equal(connectivity, max_run):
    m = _blobs((96, 128), 0)
    ref = np.asarray(jlab.label(jnp.asarray(m), connectivity, 512, max_run))
    out = tlab.label(torch.from_numpy(m), connectivity, 512, max_run)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("max_run", [None, 16])
def test_rank_labels_equal(max_run):
    m = _blobs((80, 112), 1)
    lbl = jlab.label(jnp.asarray(m), 2, 512, max_run)
    ref, n_ref = jseg.rank_labels(lbl, 2, 512, max_run)
    out, n = tseg.rank_labels(torch.from_numpy(np.array(lbl)), 2, 512,
                              max_run)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(n) == int(n_ref) > 5


def test_label_fixpoint_cap_matches_reference():
    # a cap of 1 iteration stops both before convergence, identically
    m = _blobs((64, 96), 2)
    ref = np.asarray(jlab.label(jnp.asarray(m), 2, 1, 4))
    out = tlab.label(torch.from_numpy(m), 2, 1, 4).numpy()
    np.testing.assert_array_equal(out, ref)
    full = tlab.label(torch.from_numpy(m), 2, 512, 4).numpy()
    assert (out != full).any()


@pytest.mark.parametrize("seed", [3, 4])
def test_binary_opening_equal(seed):
    m = _blobs((72, 90), seed)
    np.testing.assert_array_equal(
        tmorph.binary_opening(torch.from_numpy(m)).numpy(),
        np.asarray(jmorph.binary_opening(jnp.asarray(m))))


@pytest.mark.parametrize("connectivity,max_run", [(1, 64), (1, None),
                                                  (2, 8)])
def test_binary_fill_holes_equal(connectivity, max_run):
    m = _blobs((90, 120), 5)
    ref = np.asarray(jmorph.binary_fill_holes(jnp.asarray(m), connectivity,
                                              max_run))
    out = tmorph.binary_fill_holes(torch.from_numpy(m), connectivity,
                                   max_run).numpy()
    assert (ref & ~m).any()          # some hole was filled
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("op", ["all", "any"])
def test_block_pool_equal(op):
    m = _blobs((45, 98), 6)
    np.testing.assert_array_equal(
        tlab._block_pool(torch.from_numpy(m), 4, op).numpy(),
        np.asarray(jlab._block_pool(jnp.asarray(m), 4, op)))


@pytest.mark.parametrize("off,fill", [((1, 0), 0), ((-2, 3), 7),
                                      ((0, -1), -1), ((200, 0), 5)])
def test_shifted_equal(off, fill):
    a = np.arange(48 * 40, dtype=np.int32).reshape(48, 40)
    np.testing.assert_array_equal(
        tlab.shifted(torch.from_numpy(a), off, fill).numpy(),
        np.asarray(jlab.shifted(jnp.asarray(a), off, fill)))


def test_border_mask_equal():
    np.testing.assert_array_equal(tlab.border_mask((5, 7)).numpy(),
                                  np.asarray(jlab.border_mask((5, 7))))
