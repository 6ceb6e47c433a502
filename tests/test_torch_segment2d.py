"""Port parity for the 10-bit host engine and the per-cell measurement:
the port's segment2d.segment_ecoli and measure.measure_fov vs the JAX
package's on the CPU, on the 192^2 FOV of the JAX package's fused-vs-host
test (9 planted 10-bit cells, its shifts), and the port's own fused and
host engines held together as that test holds the JAX package's."""

import os

import numpy as np
import pytest
import torch

from hiprfish_tpu.config import TEN_BIT as JTEN_BIT
from hiprfish_tpu.config import SegmentationConfig as JSegmentationConfig
from hiprfish_tpu.pipeline import measure as jmeasure
from hiprfish_tpu.pipeline import segment2d as jsegment2d
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch.config import TEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import fused, fused_ecoli, measure, segment2d
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_10b_1023x200.npz")
CODES = [5, 37, 515, 1023, 96, 640, 17, 260, 770]
SHIFTS = [(0, 0), (1, -1), (0, 1), (-1, 0), (1, 1)]
MAX_CELLS = 256


def _fov(mod, layout):
    return mod.make_fov(layout, CODES, shape=(192, 192), seed=1,
                        laser_shifts=SHIFTS, cell_axes=(9.0, 14.0))


@pytest.fixture(scope="module")
def engines():
    jr = jsegment2d.segment_ecoli(_fov(jsynthetic, JTEN_BIT)["stack"],
                                  JSegmentationConfig(), MAX_CELLS)
    fov = _fov(synthetic, TEN_BIT)
    stack = tuple(torch.from_numpy(a) for a in fov["stack"])
    tr = segment2d.segment_ecoli(stack, SegmentationConfig(), MAX_CELLS)
    tf = fused_ecoli.segment_ecoli_device(stack, SegmentationConfig(),
                                          MAX_CELLS)
    return jr, tr, tf


def test_segment_ecoli_equals_jax(engines):
    jr, tr, _ = engines
    assert int(tr.n_cells) == int(jr.n_cells) == len(CODES)
    assert tr.segmentation.dtype == torch.int32
    np.testing.assert_array_equal(tr.segmentation.numpy(),
                                  np.asarray(jr.segmentation))
    assert tr.registered.dtype == torch.float32
    np.testing.assert_allclose(tr.registered.numpy(),
                               np.asarray(jr.registered), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tr.enhanced.numpy(), np.asarray(jr.enhanced),
                               rtol=1e-6, atol=1e-6)
    assert not tr.epithelial.any() and not tr.adjacency.any()


def test_measure_fov_equals_jax(engines):
    jr, tr, _ = engines
    avg, norm = measure.measure_fov(tr.segmentation, tr.registered,
                                    tr.n_cells, 64)
    ravg, rnorm = jmeasure.measure_fov(jr.segmentation, jr.registered,
                                       int(jr.n_cells), 64)
    assert avg.shape == norm.shape == (len(CODES), TEN_BIT.n_channels)
    np.testing.assert_allclose(avg, ravg, rtol=1e-5, atol=0)
    np.testing.assert_allclose(norm, rnorm, rtol=1e-5, atol=0)
    assert np.allclose(norm.max(axis=1), 1.0)


def _classify(arrays, static, norm):
    """The 132-d feature build of fov_step_ecoli + the kNN vote."""
    ci, _ = fused.classify_device(
        fused_ecoli.violet_features(norm, static[1]), arrays["check_heads"],
        static[6], arrays.get("scaler_mean"), arrays.get("scaler_scale"),
        arrays["train_features"], arrays["train_labels"], *static[:6])
    return ci.numpy()


def test_fused_engine_matches_host_engine(engines):
    _, tr, (seg_f, n_f, reg_f, avg_f) = engines
    assert int(n_f) == int(tr.n_cells) == len(CODES)
    a = seg_f.numpy()
    b = tr.segmentation.numpy()
    order = []
    for lab_id in range(1, len(CODES) + 1):
        mask_a = a == lab_id
        ids, cnt = np.unique(b[mask_a], return_counts=True)
        best = ids[np.argmax(cnt)]
        mask_b = b == best
        iou = (mask_a & mask_b).sum() / (mask_a | mask_b).sum()
        assert best > 0 and iou > 0.8, (lab_id, best, iou)
        order.append(int(best) - 1)
    # the fused cube is the host engine's, quantized to bf16
    np.testing.assert_allclose(reg_f.to(torch.float32).numpy(),
                               tr.registered.numpy(), rtol=8e-3, atol=1e-3)
    # the bf16 measurement lands on the host engine's f32 calls
    _, norm_h = measure.measure_fov(tr.segmentation, tr.registered,
                                    tr.n_cells, MAX_CELLS)
    avg = avg_f[1:len(CODES) + 1]
    norm_f = avg / torch.clamp(avg.max(dim=1, keepdim=True).values, min=1e-12)
    arrays, static = fused.classifier_from_numpy(load_classifier(FIXTURE),
                                                 "cpu")
    calls_f = _classify(arrays, static, norm_f)
    calls_h = _classify(arrays, static, torch.from_numpy(norm_h[order]))
    np.testing.assert_array_equal(calls_f, calls_h)
    codebook = load_classifier(FIXTURE).codebook
    planted = {TEN_BIT.code_str(c) for c in CODES}
    assert {codebook[i] for i in calls_f} == planted
