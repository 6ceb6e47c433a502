"""The benchmark's frozen work counts and bounds (``benchmark/
kernel_work.py``) equal chip_smoke.py's at the shapes of PERF.md's table of
kernels."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "benchmark"))

import kernel_work as frozen  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PX = 2000 * 2000
TILE = 488 * 170 * 2020
VOLUME = 2020 * 170 * 2020
CASES = [
    ("nlm", dict(h=2000, w=2000, pd=11)),
    ("nlm", dict(h=96, w=160, pd=80)),
    ("lpcv2d", dict(h=2000, w=2000)),
    ("lpcv2d", dict(h=96, w=160, patch=7, phi=5)),
    ("lpcv2d", dict(h=96, w=160, patch=15, phi=12)),
    ("lpcv2d", dict(h=96, w=160, patch=131, phi=5)),
    ("lpcv2d", dict(h=96, w=160, patch=11, phi=129)),
    ("label_stats", dict(pixels=PX, labelled=600000, ncols=2, row_bytes=0,
                         segments=8192)),
    ("label_stats", dict(pixels=PX, labelled=600000, ncols=43, row_bytes=0,
                         px_bytes=4, segments=8192)),
    ("label_stats", dict(pixels=PX, labelled=600000, ncols=65,
                         row_bytes=126, segments=8192)),
    ("label_stats", dict(pixels=PX, labelled=600000, ncols=144,
                         row_bytes=190, px_bytes=8, segments=8192)),
    ("label_stats", dict(pixels=TILE, labelled=30000000, ncols=2,
                         row_bytes=0, segments=8192)),
    ("label_lookup", dict(pixels=PX, segments=8192)),
    ("label_lookup", dict(pixels=TILE, segments=8192)),
    ("stats_cm", dict(pixels=63 * 2 * 2020 * 2020 // 63, labelled=3000000,
                      ncols=64, row_bytes=126, segments=16384)),
    ("lpcv3d", dict(voxels=VOLUME)),
    ("lpcv3d", dict(voxels=1040 * 170 * 550)),
    ("lpcv3d", dict(voxels=40 * 24 * 36, patch=7, theta=5, phi=6)),
    ("lpcv3d", dict(voxels=40 * 24 * 36, patch=21, theta=5, phi=4)),
    ("lpcv3d", dict(voxels=40 * 24 * 36, patch=29, theta=3, phi=4)),
]


@pytest.mark.parametrize("name,args", CASES)
def test_frozen_work_and_bound_equal_chip_smokes(name, args):
    assert frozen.kernel_work(name, **args) == cs.kernel_work(name, **args)
    assert frozen.bound(*frozen.kernel_work(name, **args)) \
        == cs.bound(*cs.kernel_work(name, **args))
    assert (frozen.PEAK_OPS, frozen.PEAK_BYTES, frozen.OPS_NLM) \
        == (cs.PEAK_OPS, cs.PEAK_BYTES, cs.OPS_NLM)
