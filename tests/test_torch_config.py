"""The port's own copies of the 7-bit and 10-bit layouts, the segmentation
defaults and the synthetic FOV generator equal the JAX package's."""

import dataclasses

import numpy as np
import pytest

from hiprfish_tpu import config as jconfig
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch import config as tconfig
from hiprfish_tpu_torch.utils import synthetic as tsynthetic


def test_seven_bit_layout_equal():
    ref = jconfig.SEVEN_BIT
    for f in dataclasses.fields(tconfig.SEVEN_BIT):
        assert getattr(tconfig.SEVEN_BIT, f.name) == getattr(ref, f.name), \
            f.name
    assert tconfig.SEVEN_BIT.blocks == ref.blocks
    assert [tconfig.SEVEN_BIT.code_str(c) for c in (1, 5, 127)] == \
        [ref.code_str(c) for c in (1, 5, 127)]


def test_ten_bit_layout_equal():
    ref = jconfig.TEN_BIT
    for f in dataclasses.fields(tconfig.TEN_BIT):
        assert getattr(tconfig.TEN_BIT, f.name) == getattr(ref, f.name), \
            f.name
    assert tconfig.TEN_BIT.blocks == ref.blocks
    # the sixth check group (violet derivative) has no block of channels
    assert len(tconfig.TEN_BIT.check_bit_groups) == 6
    assert len(tconfig.TEN_BIT.blocks) == 5
    assert [tconfig.TEN_BIT.code_str(c) for c in (1, 5, 1023)] == \
        [ref.code_str(c) for c in (1, 5, 1023)]


def test_ecoli_segmentation_defaults():
    port = tconfig.SegmentationConfig()
    assert (port.seed_area_max, port.seed_min_size, port.cell_min_size,
            port.minor_axis_min, port.minor_axis_max,
            port.max_erosion_iters) == (600, 10, 100, 15.0, 35.0, 40)


def test_segmentation_defaults_equal():
    ref = jconfig.SegmentationConfig()
    port = tconfig.SegmentationConfig()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_spectra_equal():
    lut = tsynthetic.fluorophore_spectra(tconfig.SEVEN_BIT)
    np.testing.assert_array_equal(
        lut, jsynthetic.fluorophore_spectra(jconfig.SEVEN_BIT))
    for code in (1, 37, 127):
        np.testing.assert_array_equal(
            tsynthetic.barcode_spectrum(tconfig.SEVEN_BIT, code, lut),
            jsynthetic.barcode_spectrum(jconfig.SEVEN_BIT, code))


def test_spectra_equal_ten_bit():
    lut = tsynthetic.fluorophore_spectra(tconfig.TEN_BIT)
    np.testing.assert_array_equal(
        lut, jsynthetic.fluorophore_spectra(jconfig.TEN_BIT))
    for code in (1, 37, 515, 1023):
        np.testing.assert_array_equal(
            tsynthetic.barcode_spectrum(tconfig.TEN_BIT, code, lut),
            jsynthetic.barcode_spectrum(jconfig.TEN_BIT, code))


def _assert_fov_equal(out, ref, n_lasers):
    assert len(out["stack"]) == len(ref["stack"]) == n_lasers
    for a, b in zip(out["stack"], ref["stack"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["truth_labels"], ref["truth_labels"])
    assert out["truth_barcodes"] == ref["truth_barcodes"]
    np.testing.assert_array_equal(out["spectra"], ref["spectra"])


@pytest.mark.parametrize("shape,n,seed,shifts,axes", [
    ((256, 256), 30, 1, [(0, 0), (2, -1), (0, 3), (-2, 0)], (7.0, 12.0)),
    ((96, 128), 5, 4, None, (9.0, 15.0)),
])
def test_make_fov_equal(shape, n, seed, shifts, axes):
    codes = [1 + (i * 7) % 127 for i in range(n)]
    out = tsynthetic.make_fov(tconfig.SEVEN_BIT, codes, shape=shape,
                              seed=seed, laser_shifts=shifts, cell_axes=axes)
    ref = jsynthetic.make_fov(jconfig.SEVEN_BIT, codes, shape=shape,
                              seed=seed, laser_shifts=shifts, cell_axes=axes)
    _assert_fov_equal(out, ref, 4)


def test_make_fov_equal_ten_bit():
    codes = [1 + (i * 37) % 1023 for i in range(9)]
    kw = dict(shape=(192, 160), seed=2,
              laser_shifts=[(0, 0), (2, -1), (0, 3), (-2, 0), (1, 1)],
              cell_axes=(9.0, 14.0))
    out = tsynthetic.make_fov(tconfig.TEN_BIT, codes, **kw)
    ref = jsynthetic.make_fov(jconfig.TEN_BIT, codes, **kw)
    _assert_fov_equal(out, ref, 5)
    assert out["stack"][0].shape == (192, 160, 32)


def test_flagship_fov_definition():
    assert tsynthetic.FLAGSHIP_SHAPE == (2000, 2000)
    assert len(tsynthetic.FLAGSHIP_CODES) == 400
    assert set(tsynthetic.FLAGSHIP_CODES) == set(range(1, 128))


def test_ecoli_fov_definition():
    # bench.py's 10-bit configuration
    all_codes = list(range(1, 1024))
    assert tsynthetic.ECOLI_SHAPE == (2000, 2000)
    assert list(tsynthetic.ECOLI_CODES) == \
        [all_codes[(i * 37) % 1023] for i in range(400)]
    assert tsynthetic.ECOLI_SHIFTS == ((0, 0), (2, -1), (0, 3), (-2, 0),
                                       (1, 1))
    assert tsynthetic.ECOLI_CELL_AXES == (9.0, 14.0)
