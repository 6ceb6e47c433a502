"""Port parity for the ops of the 10-bit E. coli slice vs the JAX package on
the CPU: brightest_cluster_masks, the label-table filters, small-hole
removal (exact and fast, both branches of the fast one), the per-region
double erosion, and the region properties. Masks and labels must be
equal; floats are held to rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import kmeans as jkm
from hiprfish_tpu.ops import labeling as jlab
from hiprfish_tpu.ops import morphology as jmorph
from hiprfish_tpu.ops import regionprops as jrp
from hiprfish_tpu.ops import segstats as jseg
from hiprfish_tpu.pipeline import segment2d as jseg2d
from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.config import TEN_BIT
from hiprfish_tpu_torch.ops import kmeans as tkm
from hiprfish_tpu_torch.ops import labeling as tlab
from hiprfish_tpu_torch.ops import morphology as tmorph
from hiprfish_tpu_torch.ops import regionprops as trp
from hiprfish_tpu_torch.ops import segstats as tseg
from hiprfish_tpu_torch.pipeline import segment2d as tseg2d
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)


def _blobs(shape, seed, n=24, holes=True):
    """A boolean mask of random ellipses, some touching the border, some
    overlapping, with small and large holes punched into a few."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    m = np.zeros(shape, bool)
    for _ in range(n):
        cy, cx = rng.uniform(-4, shape[0] + 4), rng.uniform(-4, shape[1] + 4)
        a, b = rng.uniform(2, 9), rng.uniform(2, 14)
        m |= ((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1.0
    if holes:
        for _ in range(n // 2):
            cy, cx = rng.randint(0, shape[0]), rng.randint(0, shape[1])
            r = rng.randint(0, 4)
            m[max(cy - r, 0):cy + r + 1, max(cx - r, 0):cx + r + 1] = False
    return m


def _holey(shape, seed):
    """_blobs plus a solid block holding square holes of areas 1 to 64, one
    hole at the border of the frame (not a hole: it touches the border)."""
    m = _blobs(shape, seed)
    m[16:56, 8:120] = True
    for i, side in enumerate((1, 2, 3, 4, 6, 8)):
        c = 12 + 18 * i
        m[30:30 + side, c:c + side] = False
    m[0:3, 60:64] = False
    return m


def _touching_labels(shape, seed):
    """Label rectangles that touch each other and the border, ids
    scattered (not sequential), with gaps."""
    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int32)
    for r in range(0, shape[0], 9):
        for c in range(0, shape[1], 13):
            if rng.rand() < 0.8:
                lab[r:r + rng.randint(5, 10), c:c + rng.randint(7, 14)] = \
                    rng.randint(1, 500)
    return lab


def _log_sum_image(shape, seed):
    """The log channel-sum of a synthetic 10-bit FOV (the engines' KMeans
    input): background, cell rims and brighter cell interiors."""
    codes = [(i * 37) % 1023 + 1 for i in range(12)]
    fov = synthetic.make_fov(TEN_BIT, codes, shape=shape, seed=seed,
                             cell_axes=(9.0, 14.0))
    total = sum(a.sum(axis=2) for a in fov["stack"])
    return np.log(total + 1e-2).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_brightest_cluster_masks(seed):
    img = _log_sum_image((160, 192), seed)
    ref = jkm.brightest_cluster_masks(jnp.asarray(img), (2, 3), 40)
    out = tkm.brightest_cluster_masks(torch.from_numpy(img), (2, 3), 40)
    assert len(out) == 2
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    fg, interior = (o.numpy() for o in out)
    assert interior.sum() > 0 and (interior & ~fg).sum() == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_relabel_sequential(seed):
    lab = _touching_labels((64, 96), seed)
    lab[0, 0] = -3
    out, n = tlab.relabel_sequential(torch.from_numpy(lab))
    ref, rn = jlab.relabel_sequential(jnp.asarray(lab))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(n) == int(rn) == len(np.unique(lab[lab > 0]))


def test_clear_border():
    lab = _touching_labels((64, 96), 2)
    out = tlab.clear_border(torch.from_numpy(lab)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jlab.clear_border(
        jnp.asarray(lab))))
    assert out[0].sum() == out[-1].sum() == 0 and out.sum() > 0


@pytest.mark.parametrize("connectivity", [1, 2])
def test_remove_small_objects(connectivity):
    m = _blobs((96, 128), 3)
    out = tlab.remove_small_objects(torch.from_numpy(m), 30, connectivity)
    ref = jlab.remove_small_objects(jnp.asarray(m), 30, connectivity)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 0 < out.numpy().sum() < m.sum()


def test_remove_small_labels():
    lab = _touching_labels((64, 96), 4)
    out = tlab.remove_small_labels(torch.from_numpy(lab), 60).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        jlab.remove_small_labels(jnp.asarray(lab), 60)))
    assert 0 < (out > 0).sum() < (lab > 0).sum()


@pytest.mark.parametrize("seed", [5, 6])
def test_remove_small_holes(seed):
    m = _holey((96, 128), seed)
    out = tmorph.remove_small_holes(torch.from_numpy(m), 20).numpy()
    ref = np.asarray(jmorph.remove_small_holes(jnp.asarray(m), 20))
    np.testing.assert_array_equal(out, ref)
    assert out.sum() > m.sum()


@pytest.mark.parametrize("num_segments,exact_fallback", [
    (32768, True),    # fast branch
    (4, True),        # n >= num_segments: the exact fallback
    (4, False),       # n >= num_segments: the mask unchanged
])
def test_remove_small_holes_fast(num_segments, exact_fallback):
    m = _holey((96, 128), 7)
    kw = dict(num_segments=num_segments, flood_max_run=64,
              exact_fallback=exact_fallback)
    before = kernels.launch_counts()
    out = tseg.remove_small_holes_fast(torch.from_numpy(m), 20, **kw).numpy()
    assert kernels.launch_counts() == before
    ref = np.asarray(jseg.remove_small_holes_fast(jnp.asarray(m), 20, **kw))
    np.testing.assert_array_equal(out, ref)
    exact = tmorph.remove_small_holes(torch.from_numpy(m), 20).numpy()
    if exact_fallback:
        np.testing.assert_array_equal(out, exact)
        assert out.sum() > m.sum()
    else:
        np.testing.assert_array_equal(out, m)


@pytest.mark.parametrize("case", ["touching", "border"])
def test_erode_labels_twice(case):
    if case == "touching":
        lab = _touching_labels((64, 96), 8)
    else:
        lab = np.zeros((40, 56), np.int32)
        lab[:12, :20] = 3             # corner
        lab[:12, 20:34] = 7           # touches 3 and the top row
        lab[18:, 10:30] = 2           # touches the bottom row
        lab[25:31, 40:] = 9           # touches the right edge
    out = tseg2d._erode_labels_twice(torch.from_numpy(lab)).numpy()
    ref = np.asarray(jseg2d._erode_labels_twice(jnp.asarray(lab)))
    np.testing.assert_array_equal(out, ref)
    assert ((out == lab) | (out == 0)).all() and 0 < (out > 0).sum() \
        < (lab > 0).sum()


def test_mean_intensities():
    rng = np.random.RandomState(9)
    lab = _touching_labels((48, 80), 9) % 61
    lab[0, :3] = [-1, 70, 60]
    img = rng.rand(48, 80, 11).astype(np.float32)
    out = trp.mean_intensities(torch.from_numpy(lab), torch.from_numpy(img),
                               64).numpy()
    ref = np.asarray(jrp.mean_intensities(jnp.asarray(lab), jnp.asarray(img),
                                          64))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)


def test_shape_props_2d():
    lab, _ = tlab.relabel_sequential(torch.from_numpy(
        _touching_labels((64, 96), 10)))
    lab = lab.numpy()
    lab[20:40, 30:34] = lab.max() + 1          # a thin vertical bar
    out = trp.shape_props_2d(torch.from_numpy(lab), 80)
    ref = jrp.shape_props_2d(jnp.asarray(lab), 80)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
