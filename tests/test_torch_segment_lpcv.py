"""Port parity for the LP-CV host engine: labeling.filter_and_relabel on
random label images, and segment2d.segment_lpcv (multispecies) on the
192^2 7-bit FOV of the JAX package's multispecies CLI test against
hiprfish_tpu.pipeline.segment2d.segment_lpcv on the CPU (both on the XLA
path semantics of NL-means and LP-CV)."""

import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.config import SegmentationConfig as JSegmentationConfig
from hiprfish_tpu.ops import labeling as jlab
from hiprfish_tpu.pipeline import segment2d as jsegment2d
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.pipeline import segment2d
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CODES = [1, 9, 65, 127, 34, 88]
MAX_CELLS = 64


def _fov(mod, layout):
    return mod.make_fov(layout, CODES, shape=(192, 192), seed=5,
                        cell_axes=(7.0, 12.0))


@pytest.mark.parametrize("drop_border", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_and_relabel_equals_jax(seed, drop_border):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 30, (40, 56)).astype(np.int32)
    labels[rng.rand(40, 56) < 0.3] = 0
    labels[5:12, 7:20] = 31           # one large inner label
    mine, n = lab.filter_and_relabel(torch.from_numpy(labels), 20,
                                     drop_border)
    ref, n_ref = jlab.filter_and_relabel(labels, 20, drop_border)
    assert mine.dtype == torch.int32
    assert int(n) == int(n_ref) > 0
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def engines():
    jr = jsegment2d.segment_lpcv(_fov(jsynthetic, JSEVEN_BIT)["stack"], None,
                                 JSegmentationConfig(), MAX_CELLS,
                                 "multispecies")
    stack = tuple(torch.from_numpy(a)
                  for a in _fov(synthetic, SEVEN_BIT)["stack"])
    tr = segment2d.segment_lpcv(stack, None, SegmentationConfig(), MAX_CELLS,
                                "multispecies")
    return jr, tr


def test_segment_lpcv_equals_jax(engines):
    jr, tr = engines
    assert int(tr.n_cells) == int(jr.n_cells) == len(CODES)
    assert tr.segmentation.dtype == torch.int32
    np.testing.assert_array_equal(tr.segmentation.numpy(),
                                  np.asarray(jr.segmentation))


def test_segment_lpcv_surfaces_equal_jax(engines):
    jr, tr = engines
    assert tr.registered.dtype == torch.float32
    np.testing.assert_array_equal(tr.registered.numpy(),
                                  np.asarray(jr.registered))
    np.testing.assert_allclose(tr.fov_sum.numpy(), np.asarray(jr.fov_sum),
                               rtol=1e-6, atol=0)
    # LP-CV divides by each line's range: on the flat background it blows
    # the channel sum's and NL-means' f32 rounding (summation order) up
    # to ~2e-2; inside the cells, where the flood runs, it stays ~3e-5
    cells = np.asarray(jr.segmentation) > 0
    np.testing.assert_allclose(tr.enhanced.numpy()[cells],
                               np.asarray(jr.enhanced)[cells], rtol=0,
                               atol=1e-4)
    assert not tr.adjacency.any() and not tr.epithelial.any()
