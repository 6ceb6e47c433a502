"""segment3d.volume_step on the CPU: one stitched volume from its tiles to
its calls, on a 144 x 96 x 40 volume of 8 synthetic cells cut into
chip_smoke's 2 x 4 grid of overlapping, shifted tiles, swept in tiles of
45 planes whose boundaries pass through cells.

It equals the stitch -> segment_3d_tiled -> make_fused_measure ->
classify_device composition that chip_smoke used before it existed,
bitwise; its spans change nothing; under a profiler it records one
``step`` with its stages and counters, and the four host reads it routes
through host_wait add to their spans' ``wait_ns``; and it imports no JAX.
A few seconds a pass.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import fused
from hiprfish_tpu_torch.pipeline import segment3d as seg3d
from hiprfish_tpu_torch.utils import logging as ulog
from hiprfish_tpu_torch.utils import synthetic, synthetic3d as s3
from tests.test_torch_no_jax import PREAMBLE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_clf_7b_127x50.npz")
# 4 x 2 x 1 cells; x centres 18, 54, 90 and 126 (+-4), so the tile
# boundaries at x = 45, 90 and 135 cut through cells
SPEC = s3.VolumeSpec(shape=(144, 96, 40), spacing=(36, 48, 40), seed=5)
TILED = dict(tile_x=45, margin=32, tile_cap=64, scan_cap=8)
MAX_CELLS = 64
Z_CHUNK = 2
STAGES = ["stitch", "enhance", "thresholds", "seeds", "tiles", "merge",
          "remap", "measure", "classify"]


@pytest.fixture(scope="module")
def volume():
    """(tiles, slabs, classifier arrays, static)."""
    lut = torch.from_numpy(np.stack([
        synthetic.barcode_spectrum(SEVEN_BIT, c)
        for c in range(1, 128)]).astype(np.float32))
    tiles = cs._volume_tiles(torch, torch.device("cpu"), SPEC, lut)

    def slabs(z0, zc):
        return s3.channel_chunk_cm(SPEC, 127, z0, zc, lut, 1, torch.bfloat16)

    arrays, static = fused.classifier_from_numpy(load_classifier(FIXTURE),
                                                 "cpu")
    return tiles, slabs, arrays, static


def _step(volume, **kw):
    tiles, slabs, arrays, static = volume
    return seg3d.volume_step([list(tiles)], slabs, arrays, static,
                             SegmentationConfig(), MAX_CELLS,
                             z_chunk=Z_CHUNK, **TILED, **kw)


def _composed(volume):
    """The composition volume_step replaces, as chip_smoke wrote it."""
    tiles, slabs, arrays, static = volume
    shape = SPEC.shape
    stitched = seg3d.stitch_tiles_device(list(tiles), (2, 4), 60, shape,
                                         pad=10)
    stitched = stitched[10:10 + shape[0], 10:10 + shape[1],
                        10:10 + shape[2]].contiguous()
    seg_xzy, n_cells, _ = seg3d.segment_3d_tiled(
        [stitched], SegmentationConfig(), MAX_CELLS, out_layout="xzy",
        **TILED)
    run = seg3d.make_fused_measure(slabs, shape, Z_CHUNK,
                                   SEVEN_BIT.n_channels, MAX_CELLS)
    avg, _ = run(seg_xzy.permute(1, 0, 2).contiguous())
    norm = avg / torch.clamp(torch.max(avg, dim=1, keepdim=True).values,
                             min=1e-12)
    pred, prob = fused.classify_device(
        norm, arrays["check_heads"], static[6], arrays.get("scaler_mean"),
        arrays.get("scaler_scale"), arrays["train_features"],
        arrays["train_labels"], *static[:6])
    return seg_xzy, n_cells, avg, pred, prob


class _Reads:
    """Stands in for segment3d's host_wait: keeps each routed read's
    value, by the innermost open span's name."""

    def __init__(self):
        self.values = []

    def __call__(self, read, value):
        out = ulog.host_wait(read, value)
        stack = ulog.RECORDER.open_stack()
        self.values.append((stack[-1][0]["name"] if stack else None, out))
        return out


@pytest.fixture(scope="module")
def runs(volume):
    """(off result, on result, the on call's records, the routed reads)."""
    mp = pytest.MonkeyPatch()
    ulog.RECORDER.reset()
    try:
        off = _step(volume)
        assert ulog.RECORDER.snapshot() == []
        reads = _Reads()
        mp.setattr(seg3d, "host_wait", reads)
        with profile(activities=[ProfilerActivity.CPU]):
            on = _step(volume)
        records = ulog.RECORDER.snapshot()
    finally:
        mp.undo()
        ulog.RECORDER.reset()
    return off, on, records, reads.values


def test_volume_step_equals_the_composition_it_replaces(volume, runs):
    off, _, _, _ = runs
    seg, n, avg, pred, prob = _composed(volume)
    assert off.n_cells == n == SPEC.n_cells
    assert off.segmentation.shape == (144, 40, 96)
    for got, want in ((off.segmentation, seg), (off.avgint, avg),
                      (off.code_idx, pred), (off.max_prob, prob)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_spans_change_nothing(runs):
    off, on, _, _ = runs
    assert off.n_cells == on.n_cells
    for a, b in zip(off[:1] + off[2:], on[:1] + on[2:]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_one_step_with_its_stages_and_counters(runs):
    off, _, records, reads = runs
    steps = [r for r in records if r["name"] == "step"]
    assert len(steps) == 1 and steps[0]["parent"] is None
    sid = steps[0]["id"]
    assert all(r["step"] == sid for r in records)
    by_name = {}
    for r in records:
        by_name.setdefault(r["name"], []).append(r)
    assert [r["name"] for r in records if r["parent"] == sid] == STAGES
    n_tiles = -(-SPEC.shape[0] // TILED["tile_x"])
    tiles = by_name["tiles"][0]
    assert [r["parent"] for r in by_name["tile"]] == [tiles["id"]] * n_tiles
    assert tiles["attrs"]["tiles"] == n_tiles == 4
    # the counters against the values the reads brought back: the codes of
    # the boundary pair sets, and one merge for each id present in a tile
    # beyond the cells they make
    present = [v for name, v in reads if name == "merge" and v.ndim == 2]
    pairs = [v for name, v in reads if name == "merge" and v.ndim == 1]
    assert len(present) == 1 and len(pairs) == n_tiles - 1
    merge = by_name["merge"][0]["attrs"]
    assert merge["pairs"] == sum(len(p) for p in pairs) > 0
    assert merge["unions"] == int(present[0][:, 1:].sum()) - off.n_cells > 0
    assert by_name["measure"][0]["attrs"]["slabs"] \
        == -(-SPEC.shape[2] // Z_CHUNK) == 20
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = next(q for q in records if q["id"] == r["parent"])
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]


def test_routed_reads_add_to_wait_ns(runs):
    _, _, records, reads = runs
    # the stitch shifts, the seeds' probe, the presence bitmaps and the
    # boundary pair sets, each inside its stage
    assert [name for name, _ in reads] == ["stitch", "seeds"] \
        + ["merge"] * 4
    shifts = reads[0][1]
    assert shifts.shape == (8, 3) and not shifts[0].any()
    for name in ("stitch", "seeds", "merge"):
        (rec,) = [r for r in records if r["name"] == name]
        assert rec["attrs"]["wait_ns"] > 0


SCRIPT = PREAMBLE + r"""
import numpy as np
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import fused, segment3d
from hiprfish_tpu_torch.utils import synthetic, synthetic3d as s3
spec = s3.VolumeSpec(shape=(72, 48, 24), spacing=(36, 48, 24), seed=2)
lut = torch.from_numpy(np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                                 for c in range(1, 128)]).astype(np.float32))
vol = s3.build_sum_volume(spec, 127, lut.sum(dim=1), device="cpu")
tiles = [vol[:40, :, :], vol[32:, :, :]]
arrays, static = fused.classifier_from_numpy(load_classifier(sys.argv[1]),
                                             "cpu")
res = segment3d.volume_step(
    [tiles], lambda z0, zc: s3.channel_chunk_cm(spec, 127, z0, zc, lut, 1),
    arrays, static, SegmentationConfig(), 16, grid=(2, 1), overlap=8,
    tile_x=36, margin=16, tile_cap=16)
assert not {"jax", "hiprfish_tpu"} & {m.split(".")[0] for m in sys.modules
                                      if sys.modules[m] is not None}
print("cells", res.n_cells)
"""


def test_volume_step_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, FIXTURE],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["cells", "2"]
