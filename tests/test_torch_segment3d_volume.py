"""Port parity: the untiled 3D engine (segment_3d, segment_3d_from_sum and
the seed filter remove_small_objects_fast), its 3D shape columns, the
Blender volume writers, the t-stack average and the host tile stitcher
against the JAX package on the CPU, on numpy inputs made from a seed.

Two volumes, each segmented once per module by both packages (f32 LP-CV on
both sides):

- the periodic grid of tests/test_biofilm_and_3d.py::_make_volume_stack at
  96 x 64 x 32 (9 cells on a 20-px y pitch), on which the reference
  registers the 633 nm laser by (0, 20, 0);
- a jittered 96 x 72 x 40 volume of the port's synthetic3d (9 cells, seed
  3) with lasers 2-4 rolled by planted shifts, which both packages recover
  and on which both call every planted code.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SegmentationConfig as JConfig
from hiprfish_tpu.io import outputs as jout
from hiprfish_tpu.models.artifacts import load_classifier as jload
from hiprfish_tpu.ops import register as jreg
from hiprfish_tpu.ops import regionprops as jrp
from hiprfish_tpu.ops import segstats as jsegstats
from hiprfish_tpu.pipeline import segment3d as jseg3d
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.io import outputs as tout
from hiprfish_tpu_torch.models import classifier
from hiprfish_tpu_torch.models.artifacts import load_classifier as tload
from hiprfish_tpu_torch.ops import regionprops as trp
from hiprfish_tpu_torch.ops import segstats as tsegstats
from hiprfish_tpu_torch.pipeline import segment3d as tseg3d
from hiprfish_tpu_torch.utils import synthetic, synthetic3d
from tests.test_biofilm_and_3d import _make_volume_stack

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_7b_127x50.npz")
MAX_CELLS = 64
PERIODIC_CODES = [1, 9, 65, 127, 3, 5, 17, 33, 64]
# the jittered volume: 3 x 3 x 1 grid nodes, and the rolls of lasers 1-3
# (laser 0 stays); registration must find the opposite shifts
JITTER_SPEC = synthetic3d.VolumeSpec(shape=(96, 72, 40), spacing=(32, 24, 40),
                                     seed=3)
ROLLS = [(0, 0, 0), (2, -1, 1), (-1, 2, 0), (1, 1, -1)]


def jittered_volume():
    """(per-laser (X, Y, Z, C_l) blocks with lasers 1-3 rolled, truth
    labels (X, Y, Z) with node ids, the planted code of each node)."""
    spec = JITTER_SPEC
    lut = torch.from_numpy(np.stack([
        synthetic.barcode_spectrum(SEVEN_BIT, c)
        for c in range(1, 128)]).astype(np.float32))
    z = spec.shape[2]
    cube = synthetic3d.channel_chunk_cm(spec, 127, 0, z, lut, 1) \
        .permute(2, 3, 1, 0).contiguous().numpy()
    truth = synthetic3d.truth_chunk(spec, 127, 0, z, "cpu")[0].numpy()
    blocks = [np.ascontiguousarray(np.roll(cube[..., lo:hi], r, (0, 1, 2)))
              for (lo, hi), r in zip(SEVEN_BIT.blocks, ROLLS)]
    return blocks, truth, synthetic3d.node_codes(spec, 127) + 1


def _jax_shifts(blocks):
    sums = [jnp.log(jnp.sum(jnp.asarray(b), axis=3) + 1e-8) for b in blocks]
    return [tuple(int(v) for v in np.asarray(
        jreg.register_translation_3d(sums[0], s))) for s in sums]


@pytest.fixture(scope="module")
def volumes():
    """{name: (blocks, JAX segment_3d outputs, JAX shifts, truth, codes)}
    for the periodic and the jittered volume."""
    periodic, _ = _make_volume_stack(PERIODIC_CODES, (96, 64, 32))
    jittered, truth, codes = jittered_volume()
    out = {}
    for name, blocks, tr, cd in (("periodic", periodic, None, None),
                                 ("jittered", jittered, truth, codes)):
        seg, n, reg, enh = jseg3d.segment_3d(blocks, JConfig(), MAX_CELLS)
        out[name] = (blocks, (np.asarray(seg), int(n), np.asarray(reg)),
                     _jax_shifts(blocks), tr, cd)
    return out


@pytest.fixture(scope="module")
def ported(volumes):
    """{name: (labels, n_cells, registered, shifts)} of the port's
    segment_3d on each volume, on the CPU."""
    out = {}
    for name, (blocks, *_rest) in volumes.items():
        shifts = []
        seg, n, reg, enh = tseg3d.segment_3d(
            [torch.from_numpy(b) for b in blocks], SegmentationConfig(),
            MAX_CELLS, shifts=shifts)
        assert enh.shape == seg.shape and enh.dtype == torch.float32
        out[name] = (seg.numpy(), n, reg.numpy(), shifts)
    return out


@pytest.mark.parametrize("name", ["periodic", "jittered"])
def test_segment_3d_equals_jax(volumes, ported, name):
    _, (seg_j, n_j, reg_j), shifts_j, _, _ = volumes[name]
    seg, n, reg, shifts = ported[name]
    assert n == n_j == 9
    assert seg.dtype == np.int32
    np.testing.assert_array_equal(seg, seg_j)
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-6)
    assert shifts == shifts_j


@pytest.mark.parametrize("name", ["periodic", "jittered"])
def test_segment_3d_from_sum_equals_jax(volumes, name):
    """The port's engine on the JAX package's own channel sum of its
    registered cube gives the labels of the JAX segment_3d (which is
    segment_3d_from_sum of that sum)."""
    _, (seg_j, n_j, reg_j), _, _, _ = volumes[name]
    vol_sum = np.array(jnp.sum(jnp.asarray(reg_j), axis=3))
    box = [torch.from_numpy(vol_sum)]
    seg, n, enh = tseg3d.segment_3d_from_sum(box, SegmentationConfig(),
                                             MAX_CELLS)
    assert box == [] and n == n_j
    np.testing.assert_array_equal(seg.numpy(), seg_j)


def test_periodic_fixture_keeps_the_reference_shift(volumes, ported):
    """The JAX package's register_volume_stack registers the 633 nm laser of
    the periodic grid by (0, 20, 0), one y pitch, although the lasers were
    not shifted: the 633 nm channels see only the cells whose code has that
    bit, and on a perfect lattice a pitch aligns them as well as no shift
    does. This is the reference's behaviour, kept on purpose: the port
    adds no shift clamp that the JAX register_volume_stack lacks, and
    reproduces the shift (and the registered cube) exactly."""
    _, _, shifts_j, _, _ = volumes["periodic"]
    assert shifts_j == [(0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 20, 0)]
    assert ported["periodic"][3] == shifts_j


def _majority_calls(seg, truth, calls):
    """{planted node id: call of the label covering most of its voxels}."""
    out = {}
    for t in range(1, int(truth.max()) + 1):
        labs = seg[truth == t]
        labs = labs[labs > 0]
        out[t] = calls[int(np.bincount(labs).argmax()) - 1] if labs.size \
            else None
    return out


def test_jittered_volume_shifts_and_calls(volumes, ported):
    """On a volume without a lattice both packages find the planted
    shifts, and each package's own spectra and classifier call every
    planted cell's code."""
    blocks, (seg_j, n_j, reg_j), shifts_j, truth, codes = volumes["jittered"]
    seg, n, reg, shifts = ported["jittered"]
    want = [tuple(-v for v in r) for r in ROLLS]
    assert shifts == shifts_j == want
    planted = {t: SEVEN_BIT.code_str(int(c)) for t, c in
               enumerate(codes, 1)}
    avg = trp.mean_intensities(torch.from_numpy(seg), torch.from_numpy(reg),
                               MAX_CELLS)[1:n + 1].numpy()
    calls, _, _, _ = classifier.classify(
        tload(FIXTURE), avg / avg.max(axis=1, keepdims=True), "cpu")
    assert _majority_calls(seg, truth, calls) == planted
    avg_j = np.asarray(jrp.mean_intensities(jnp.asarray(seg_j),
                                            jnp.asarray(reg_j),
                                            MAX_CELLS))[1:n_j + 1]
    calls_j = jload(FIXTURE).classify(
        jnp.asarray(avg_j / avg_j.max(axis=1, keepdims=True)))[0]
    assert _majority_calls(seg_j, truth, list(calls_j)) == planted


def _random_mask(kind):
    rng = np.random.RandomState(11)
    if kind == "2d":
        return rng.rand(64, 72) < 0.42
    return rng.rand(24, 20, 16) < 0.14


@pytest.mark.parametrize("kind,conn,num_segments,exact_fallback", [
    ("2d", 1, 32768, True), ("2d", 2, 32768, True), ("3d", 3, 32768, True),
    # fewer segments than components: the exact full-size count, or the
    # pass-through
    ("2d", 1, 8, True), ("2d", 1, 8, False), ("3d", 3, 8, True),
    ("3d", 3, 8, False)])
def test_remove_small_objects_fast_equals_jax(kind, conn, num_segments,
                                              exact_fallback):
    mask = _random_mask(kind)
    kw = dict(num_segments=num_segments, exact_fallback=exact_fallback)
    got = tsegstats.remove_small_objects_fast(torch.from_numpy(mask), 5,
                                              conn, **kw).numpy()
    want = np.asarray(jsegstats.remove_small_objects_fast(
        jnp.asarray(mask), 5, conn, **kw))
    np.testing.assert_array_equal(got, want)
    if num_segments == 8 and not exact_fallback:
        np.testing.assert_array_equal(got, mask)
    else:
        assert 0 < got.sum() < mask.sum()


def test_shape_props_3d_equals_jax(volumes):
    """Bitwise on every cell (float32 sums below 2^24 are exact); the
    background row's area too (its coordinate sums exceed 2^24, where the
    reference's float32 sum rounds in pixel order)."""
    _, (seg_j, _, _), _, truth, _ = volumes["jittered"]
    for labels in (seg_j, truth):
        got = trp.shape_props_3d(torch.from_numpy(labels), MAX_CELLS)
        want = jrp.shape_props_3d(jnp.asarray(labels), MAX_CELLS)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy()[1:],
                                          np.asarray(want[k])[1:])
        assert float(got["area"][0]) == float(want["area"][0])
        assert float(got["area"][1:].sum()) == float((labels > 0).sum())


def test_bvox_writers_byte_identical(tmp_path, monkeypatch):
    rng = np.random.RandomState(4)
    vol = rng.rand(7, 5, 3).astype(np.float32)
    ident = rng.rand(7, 5, 3, 3).astype(np.float32)
    for side, mod in (("port", tout), ("jax", jout)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        mod.save_bvox(vol, "v.bvox")
        mod.save_identification_bvox(ident, "s")
    names = ["v.bvox"] + [f"s_identification_{c}.bvox" for c in "rgb"]
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes()
    head = np.frombuffer((tmp_path / "port" / "v.bvox").read_bytes()[:16],
                         "<i4")
    assert head.tolist() == [7, 5, 3, 1]


def test_save_npy_streams_the_bytes_of_np_save(tmp_path):
    vol = torch.from_numpy(np.random.RandomState(6).rand(9, 4, 3, 5)
                           .astype(np.float32))
    tout.save_npy(str(tmp_path / "a.npy"), vol, rows=40)
    np.save(tmp_path / "b.npy", vol.numpy())
    assert (tmp_path / "a.npy").read_bytes() \
        == (tmp_path / "b.npy").read_bytes()


def test_register_tstack_average_equals_jax():
    import scipy.ndimage as ndi

    rng = np.random.RandomState(0)
    base = ndi.gaussian_filter(rng.rand(32, 32, 8, 3).astype(np.float32),
                               (2, 2, 1, 0)).astype(np.float32)
    vols = [base, np.roll(base, (2, -1, 0), (0, 1, 2)),
            np.roll(base, (-3, 2, 1), (0, 1, 2))]
    got = tseg3d.register_tstack_average([torch.from_numpy(v) for v in vols])
    want = np.asarray(jseg3d.register_tstack_average(vols))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["blend", "shifted"])
def test_stitch_tiles_equals_jax(case):
    rng = np.random.RandomState(2)
    if case == "blend":
        tile = rng.rand(20, 20, 4).astype(np.float32)
        tiles, masks = [tile] * 4, [np.ones_like(tile, bool)] * 4
        args = ((2, 2), (20, 20, 4), 4, (60, 60, 24))
    else:
        import scipy.ndimage as ndi

        # 2 x 2 tiles of (64, 64, 8) with a 56-px overlap cut from one
        # smooth scene, each window moved by its own small shift, and
        # masks with holes
        scene = ndi.gaussian_filter(rng.rand(96, 96, 12), 2) \
            .astype(np.float32)
        moves = [(0, 0, 0), (1, -2, 1), (-1, 1, 0), (2, 0, -1)]
        tiles, masks = [], []
        for i in range(2):
            for j in range(2):
                dy, dx, dz = moves[i * 2 + j]
                y0, x0 = 8 + i * 8 + dy, 8 + j * 8 + dx
                tiles.append(np.ascontiguousarray(
                    scene[y0:y0 + 64, x0:x0 + 64, 2 + dz:10 + dz]))
                masks.append(rng.rand(64, 64, 8) > 0.1)
        args = ((2, 2), (64, 64, 8), 56, (96, 96, 28))
    got = tseg3d.stitch_tiles(tiles, masks, *args, pad=10, device="cpu")
    want = jseg3d.stitch_tiles(tiles, masks, *args, pad=10)
    assert got.dtype == np.float32 and got.shape == args[3]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dim_codes_fall_below_the_background_in_both_packages():
    """The reference's behaviour behind chip_smoke's phase 16c bar: with
    uniform noise on each of the 63 channels the channel sum's background
    is ~0.95, and a cell whose code sums its spectrum to a tenth of the
    median code's (codes 8, 16 and 24: 2.4-4.0 against 27.4) falls below
    the log10 KMeans background threshold. On a 144 x 72 x 110 piece of
    phase 16c's tile (seed 5; 16 planted cells, node 16 of code 16) both
    packages give the same labels and miss exactly that cell."""
    spec = synthetic3d.VolumeSpec(shape=(144, 72, 110), spacing=(36, 36, 52),
                                  seed=5)
    lut = torch.from_numpy(np.stack([
        synthetic.barcode_spectrum(SEVEN_BIT, c)
        for c in range(1, 128)]).astype(np.float32))
    z = spec.shape[2]
    cube = synthetic3d.channel_chunk_cm(spec, 127, 0, z, lut, 1) \
        .permute(2, 3, 1, 0).contiguous().numpy()
    truth = synthetic3d.truth_chunk(spec, 127, 0, z, "cpu")[0].numpy()
    blocks = [np.ascontiguousarray(cube[..., lo:hi])
              for lo, hi in SEVEN_BIT.blocks]
    spectrum = lut.sum(dim=1).numpy()
    dim = spectrum[synthetic3d.node_codes(spec, 127)] \
        < 0.2 * np.median(spectrum)
    seg, n, _, _ = tseg3d.segment_3d([torch.from_numpy(b) for b in blocks],
                                     SegmentationConfig(), MAX_CELLS)
    seg_j, n_j, _, _ = jseg3d.segment_3d(blocks, JConfig(), MAX_CELLS)
    seg_j = np.asarray(seg_j)
    np.testing.assert_array_equal(seg.numpy(), seg_j)
    found = np.array([
        np.bincount(seg_j[truth == t], minlength=2)[1:].max() * 2
        >= (truth == t).sum() for t in range(1, spec.n_cells + 1)])
    assert n == int(n_j) == spec.n_cells - 1
    assert np.flatnonzero(dim).tolist() == [15]
    np.testing.assert_array_equal(found, ~dim)
