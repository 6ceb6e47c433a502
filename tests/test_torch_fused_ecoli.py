"""Port parity for the whole 10-bit slice: the port's fov_step_ecoli vs the
JAX package's fused_ecoli.fov_step_ecoli on the CPU, on a 256^2 synthetic
10-bit FOV with 16 planted cells (cell axes (9, 14), bench.py's five
per-laser shifts), max_cells=256 and the committed 1023-class classifier
loaded once by each package's loader.

Expected: equal n_cells, equal segmentation, equal code_idx on the valid
rows, spectra and vote fractions within rtol 1e-5. The float differences
on the way are summation orders (channel sums and maxima, FFT, Lloyd
reductions, per-label sums); none of them moves a pixel across a
threshold on this fixture."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import TEN_BIT as JTEN_BIT
from hiprfish_tpu.config import SegmentationConfig as JSegmentationConfig
from hiprfish_tpu.models.artifacts import load_classifier as jload
from hiprfish_tpu.pipeline import fused as jfused
from hiprfish_tpu.pipeline import fused_ecoli as jfused_ecoli
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.config import TEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier as tload
from hiprfish_tpu_torch.pipeline import fused as tfused
from hiprfish_tpu_torch.pipeline import fused_ecoli as tfused_ecoli
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_10b_1023x200.npz")
CODES = [(i * 37) % 1023 + 1 for i in range(16)]
SHAPE = (256, 256)
MAX_CELLS = 256


@pytest.fixture(scope="module")
def both_results():
    jfov = jsynthetic.make_fov(JTEN_BIT, CODES, shape=SHAPE, seed=2,
                               laser_shifts=list(synthetic.ECOLI_SHIFTS),
                               cell_axes=synthetic.ECOLI_CELL_AXES)
    ja, js = jfused.classifier_to_device_args(jload(FIXTURE))
    jr = jfused_ecoli.fov_step_ecoli(
        tuple(jnp.asarray(a) for a in jfov["stack"]), ja,
        JSegmentationConfig(), MAX_CELLS, js)
    # the port's side: its own FOV generator, config and loader
    fov = synthetic.make_fov(TEN_BIT, CODES, shape=SHAPE, seed=2,
                             laser_shifts=synthetic.ECOLI_SHIFTS,
                             cell_axes=synthetic.ECOLI_CELL_AXES)
    ta, ts = tfused.classifier_from_numpy(tload(FIXTURE), "cpu")
    before = kernels.launch_counts()
    tr = tfused_ecoli.fov_step_ecoli(
        tuple(torch.from_numpy(a) for a in fov["stack"]), ta,
        SegmentationConfig(), MAX_CELLS, ts)
    # CPU tensors take the plain versions: no kernel launched
    assert kernels.launch_counts() == before
    return jr, tr, fov


def test_fov_step_ecoli_cells_and_segmentation_equal(both_results):
    jr, tr, _ = both_results
    seg_j, n_j = jr[0], jr[1]
    assert int(tr.n_cells) == int(n_j) >= 12
    assert tr.segmentation.dtype == torch.int32
    np.testing.assert_array_equal(tr.segmentation.numpy(), np.asarray(seg_j))
    assert int(tr.segmentation.max()) == int(tr.n_cells)
    assert int(tr.valid.sum()) == int(tr.n_cells)


def test_fov_step_ecoli_calls_and_spectra_equal(both_results):
    jr, tr, _ = both_results
    _, n_j, norm_j, code_j, prob_j = jr
    v = tr.valid.numpy()
    np.testing.assert_array_equal(tr.code_idx.numpy()[v],
                                  np.asarray(code_j)[v])
    np.testing.assert_allclose(tr.avgint_norm.numpy(), np.asarray(norm_j),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(tr.max_prob.numpy()[v],
                               np.asarray(prob_j)[v], rtol=1e-5)


def test_fov_step_ecoli_avgint_equals_segment_device(both_results):
    # the reference returns avgint from segment_ecoli_device, not from the
    # step: hold the port's step avgint to the JAX engine's
    _, tr, fov = both_results
    _, n_j, _, avg_j = jfused_ecoli.segment_ecoli_device(
        tuple(jnp.asarray(a) for a in fov["stack"]), JSegmentationConfig(),
        MAX_CELLS)
    assert int(n_j) == int(tr.n_cells)
    np.testing.assert_allclose(tr.avgint.numpy(), np.asarray(avg_j),
                               rtol=1e-5, atol=0)


def test_fov_step_ecoli_calls_match_planted_barcodes(both_results):
    # majority-overlap match of found cells to planted ones, then the
    # planted barcode must be the call
    _, tr, fov = both_results
    seg = tr.segmentation.numpy()
    truth = fov["truth_labels"]
    codebook = tload(FIXTURE).codebook
    correct = 0
    for lab in range(1, int(tr.n_cells) + 1):
        ids, cnt = np.unique(truth[seg == lab], return_counts=True)
        tid = ids[np.argmax(cnt)]
        assert tid > 0
        correct += codebook[int(tr.code_idx[lab])] == \
            TEN_BIT.code_str(CODES[tid - 1])
    assert correct == int(tr.n_cells)


def test_segment_ecoli_device_registered_cube_is_bf16():
    fov = synthetic.make_fov(TEN_BIT, CODES[:9], shape=(192, 192), seed=1,
                             laser_shifts=synthetic.ECOLI_SHIFTS,
                             cell_axes=synthetic.ECOLI_CELL_AXES)
    seg, n, registered, avgint = tfused_ecoli.segment_ecoli_device(
        tuple(torch.from_numpy(a) for a in fov["stack"]),
        SegmentationConfig(), 64)
    assert registered.dtype == torch.bfloat16
    assert registered.shape == (192, 192, 95)
    assert seg.dtype == torch.int32 and int(n) == 9
    assert avgint.shape == (64, 95) and float(avgint[0].abs().sum()) == 0.0
