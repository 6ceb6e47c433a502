"""Port parity for the whole 7-bit slice: the port's fov_step vs the JAX
package's fused.fov_step on the CPU, on a 256^2 synthetic FOV with 30
planted cells and the committed 127-code classifier.

Expected: equal n_cells, equal segmentation, equal code_idx on the valid
rows, avgint within rtol 1e-5. The only float differences on the way are
summation orders (channel sums of the projections, FFT, the box filter's
running sums, the Lloyd reductions, the per-label sums); none of them
moves a pixel across a threshold on this fixture, so any differing pixel
is a fault of the port."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.config import SegmentationConfig as JSegmentationConfig
from hiprfish_tpu.models.artifacts import load_classifier as jload
from hiprfish_tpu.pipeline import fused as jfused
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier as tload
from hiprfish_tpu_torch.pipeline import fused as tfused
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_7b_127x50.npz")
SHIFTS = [(0, 0), (2, -1), (0, 3), (-2, 0)]


@pytest.fixture(scope="module")
def both_results():
    codes = [1 + (i * 7) % 127 for i in range(30)]
    jfov = jsynthetic.make_fov(JSEVEN_BIT, codes, shape=(256, 256), seed=1,
                               laser_shifts=SHIFTS, cell_axes=(7.0, 12.0))
    ja, js = jfused.classifier_to_device_args(jload(FIXTURE))
    jr = jfused.fov_step(tuple(jnp.asarray(a) for a in jfov["stack"]), ja,
                         JSegmentationConfig(), 64, js)
    # the port's side: its own FOV generator, config and loader
    fov = synthetic.make_fov(SEVEN_BIT, codes, shape=(256, 256), seed=1,
                             laser_shifts=SHIFTS, cell_axes=(7.0, 12.0))
    ta, ts = tfused.classifier_from_numpy(tload(FIXTURE), "cpu")
    tr = tfused.fov_step(tuple(torch.from_numpy(a) for a in fov["stack"]),
                         ta, SegmentationConfig(), 64, ts)
    return jr, tr


def test_fov_step_cells_and_segmentation_equal(both_results):
    jr, tr = both_results
    assert int(tr.n_cells) == int(jr.n_cells) >= 25
    assert tr.segmentation.dtype == torch.int32
    np.testing.assert_array_equal(tr.segmentation.numpy(),
                                  np.asarray(jr.segmentation))
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))


def test_fov_step_calls_and_spectra_equal(both_results):
    jr, tr = both_results
    v = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.code_idx.numpy()[v],
                                  np.asarray(jr.code_idx)[v])
    np.testing.assert_allclose(tr.avgint.numpy(), np.asarray(jr.avgint),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(tr.avgint_norm.numpy(),
                               np.asarray(jr.avgint_norm), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tr.max_prob.numpy()[v],
                               np.asarray(jr.max_prob)[v], rtol=1e-5)


def test_segment_lpcv_registered_cube_is_bf16():
    fov = synthetic.make_fov(SEVEN_BIT, [3, 9, 17, 33, 65, 100, 127, 5, 6],
                             shape=(160, 160), seed=2, laser_shifts=SHIFTS,
                             cell_axes=(7.0, 12.0))
    seg, registered = tfused.segment_lpcv_device(
        tuple(torch.from_numpy(a) for a in fov["stack"]), None,
        SegmentationConfig(), 32)
    assert registered.dtype == torch.bfloat16
    assert registered.shape == (160, 160, 63)
    assert seg.dtype == torch.int32 and int(seg.max()) > 0
