"""chip_smoke.py's work counts and bounds of the six CUDA kernels at the
main paths' shapes: the operations and bytes each kernel must at least do,
and the least time the H100 could take for them (the larger of the
operations over 67 TFLOP/s f32 and the bytes over 3.35 TB/s)."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

HEADER = ROOT / "hiprfish_tpu_torch" / "csrc" / "lpcv3d_tables.cuh"


def test_lpcv3d_ops_follow_the_generated_header():
    text = HEADER.read_text()
    n_orient = int(re.search(r"#define HF_LP3D_NORIENT (\d+)", text)[1])
    patch = int(re.search(r"#define HF_LP3D_PATCH (\d+)", text)[1])
    n_cx = len(re.findall(r"CX\(\d+, \d+\)",
                          text[text.index("#define HF_LP3D_SELECT(CX)"):]))
    assert (n_orient, patch, n_cx) == (72, 11, 640)
    # min and max of the samples after the first, ratio (2 subtractions,
    # a max, a divide), the mean's adds, 2 ops per compare-exchange, the
    # quartile combine
    assert cs.OPS_LPCV3D == (n_orient * (patch - 1) * 2 + n_orient * 4
                             + n_orient + 2 * n_cx + 10) == 3090


def test_nlm_ops_per_pixel_and_offset():
    # squared difference (sub, mul), running column and row sums (2 adds,
    # 2 subtractions), the weight (max, mul by the folded constant, exp2)
    # and two accumulations (an FMA and an add, twice)
    assert cs.OPS_NLM == 2 + 4 + 3 + 2 * 3 == 15


@pytest.mark.parametrize("name,kw,ops,nbytes,ms,by", [
    # B1: 2000^2 px x 264 offsets (pd 11) x 15 ops; one f32 in, one out
    ("nlm", dict(h=2000, w=2000, pd=11), 2000 ** 2 * 264 * 15,
     8 * 2000 ** 2, 0.2364179104477612, "operations"),
    # B2: 281 ops per pixel
    ("lpcv2d", dict(h=2000, w=2000), 2000 ** 2 * 281, 8 * 2000 ** 2,
     0.016776119402985075, "operations"),
    # B6 on the 256 x 170 x 256 sub-volume and on the whole volume
    ("lpcv3d", dict(voxels=256 * 170 * 256), 256 * 170 * 256 * 3090,
     8 * 256 * 170 * 256, 0.5138218029850746, "operations"),
    ("lpcv3d", dict(voxels=2020 * 170 * 2020), 2020 * 170 * 2020 * 3090,
     8 * 2020 * 170 * 2020, 31.991554029850747, "operations"),
    # B4: 2000^2 labels in, 2000^2 f32 out, a 16,384-entry table
    ("label_lookup", dict(pixels=2000 ** 2, segments=16384), 2000 ** 2,
     8 * 2000 ** 2 + 4 * 16384, 0.009571801791044776, "bytes"),
    # B3, 7-bit set: 158,000 labelled px x (2 + 63) columns; labels, the
    # labelled pixels' bf16 rows and the table
    ("label_stats", dict(pixels=2000 ** 2, labelled=158000, ncols=65,
                         row_bytes=126, segments=16384),
     158000 * 65, 4 * 2000 ** 2 + 158000 * 126 + 4 * 16384 * 65,
     0.0119904, "bytes"),
    # B3, 10-bit set: aux int32 and mask f32 per pixel, 144 columns
    ("label_stats", dict(pixels=2000 ** 2, labelled=158000, ncols=144,
                         row_bytes=190, px_bytes=8, segments=16384),
     158000 * 144, 12 * 2000 ** 2 + 158000 * 190 + 4 * 16384 * 144,
     0.02610662208955224, "bytes"),
    # B3, counts only (seed filters, small holes): the labels and the
    # two-column table
    ("label_stats", dict(pixels=2000 ** 2, labelled=158000, ncols=2,
                         row_bytes=0, segments=16384),
     158000 * 2, 4 * 2000 ** 2 + 4 * 16384 * 2, 0.004815245373134328,
     "bytes"),
    # B3, counts + the 41-class erosion-depth histogram: an int32 class per
    # pixel, 43 columns
    ("label_stats", dict(pixels=2000 ** 2, labelled=158000, ncols=43,
                         row_bytes=0, px_bytes=4, segments=16384),
     158000 * 43, 8 * 2000 ** 2 + 4 * 16384 * 43, 0.010393447164179104,
     "bytes"),
    # B3, counts on a 3D tile's (360 + 2 x 64) x 170 x 2020 labels with
    # 3e7 labelled voxels and 8192 segments
    ("label_stats", dict(pixels=488 * 170 * 2020, labelled=30_000_000,
                         ncols=2, row_bytes=0, segments=8192),
     30_000_000 * 2, 4 * 488 * 170 * 2020 + 4 * 8192 * 2,
     0.20011413014925372, "bytes"),
    # B4 on the same tile: 1.34 GB of labels in and values out
    ("label_lookup", dict(pixels=488 * 170 * 2020, segments=8192),
     488 * 170 * 2020, 8 * 488 * 170 * 2020 + 4 * 8192, 0.4001989158208955,
     "bytes"),
    # B5: a (63, 2, 2020, 2020) slab with 3.5e6 labelled voxels
    ("stats_cm", dict(pixels=2 * 2020 ** 2, labelled=3_500_000, ncols=64,
                      row_bytes=126, segments=16384),
     3_500_000 * 64, 4 * 2 * 2020 ** 2 + 3_500_000 * 126 + 4 * 16384 * 64,
     0.1426380608955224, "bytes"),
])
def test_kernel_work_and_bound(name, kw, ops, nbytes, ms, by):
    assert cs.kernel_work(name, **kw) == (ops, nbytes)
    bound_ms, bound_by = cs.bound(ops, nbytes)
    assert bound_by == by
    assert bound_ms == pytest.approx(ms, rel=1e-12)


def test_kernel_work_refuses_unknown_kernels():
    with pytest.raises(ValueError, match="unknown kernel"):
        cs.kernel_work("conv", pixels=1)
