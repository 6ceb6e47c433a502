"""Port parity: the 3D volume path (stitch, 3D registration, KMeans
thresholds, the margin-tiled segmentation with its boundary union-find,
streamed measurement, classification) vs the JAX package on the CPU.

The JAX tiled run takes ~10 s here, so it runs once per module.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.config import SegmentationConfig as JConfig
from hiprfish_tpu.models.artifacts import load_classifier as jload
from hiprfish_tpu.ops import kmeans as jkm
from hiprfish_tpu.ops import register as jreg
from hiprfish_tpu.pipeline import fused as jfused
from hiprfish_tpu.pipeline import segment3d as jseg3d
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu.utils import synthetic3d as j3
from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier as tload
from hiprfish_tpu_torch.ops import kmeans as tkm
from hiprfish_tpu_torch.ops import register as treg
from hiprfish_tpu_torch.pipeline import fused as tfused
from hiprfish_tpu_torch.pipeline import segment3d as tseg3d

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_7b_127x50.npz")
CODES = [1, 9, 65, 127, 3, 5, 17, 33, 64]
TILED = dict(max_cells=64, tile_x=48, margin=32, tile_cap=64, chunk_xy=48)


def _volume_stack(codes, shape):
    """The (X, Y, Z, 63) spectral volume and truth of
    tests/test_biofilm_and_3d.py::_make_volume_stack: ellipsoidal cells on
    a grid, one barcode spectrum each, uniform noise."""
    rng = np.random.RandomState(0)
    x, y, z = shape
    lut = jsynthetic.fluorophore_spectra(JSEVEN_BIT)
    vol = rng.rand(x, y, z, JSEVEN_BIT.n_channels).astype(np.float32) * 0.01
    truth = np.zeros(shape, np.int32)
    grid = int(np.ceil(len(codes) ** 0.5))
    xs = np.linspace(12, x - 12, grid)
    ys = np.linspace(12, y - 12, grid)
    xx, yy, zz = np.mgrid[:x, :y, :z]
    for i, c in enumerate(codes):
        cx, cy, cz = xs[i // grid], ys[i % grid], z / 2
        r2 = (((xx - cx) / 6.0) ** 2 + ((yy - cy) / 4.0) ** 2
              + ((zz - cz) / 5.0) ** 2)
        inside = r2 <= 1.0
        spec = jsynthetic.barcode_spectrum(JSEVEN_BIT, c, lut)
        profile = np.where(inside, 1.0 - 0.2 * np.sqrt(np.clip(r2, 0, 1)),
                           0.0)
        vol += profile[..., None] * spec[None, None, None, :]
        truth[inside & (truth == 0)] = i + 1
    return vol, truth


@pytest.fixture(scope="module")
def volume():
    cube, truth = _volume_stack(CODES, (144, 96, 40))
    blocks = [cube[..., lo:hi] for lo, hi in JSEVEN_BIT.blocks]
    vol_sum = np.asarray(jnp.sum(jseg3d.register_volume_stack(blocks),
                                 axis=3))
    return cube, truth, vol_sum


@pytest.fixture(scope="module")
def jax_tiled(volume):
    _, _, vol_sum = volume
    seg, n, _ = jseg3d.segment_3d_tiled(jnp.asarray(vol_sum),
                                        JConfig(kmeans_iters=20), **TILED)
    return np.asarray(seg), int(n)


@pytest.mark.parametrize("out_layout,scan_cap,tile_x", [
    ("xyz", 0, 48), ("xzy", 0, 48), ("xyz", 8, 48),
    # boundaries at x = 36, 72, 108: the middle cell column (x 66..78)
    # straddles x = 72, so the union-find merges its two halves
    ("xyz", 0, 36)])
def test_segment_3d_tiled_matches_jax(volume, jax_tiled, out_layout,
                                      scan_cap, tile_x):
    _, _, vol_sum = volume
    seg_j, n_j = jax_tiled
    seg, n, enh = tseg3d.segment_3d_tiled(
        [torch.from_numpy(vol_sum.copy())],
        SegmentationConfig(kmeans_iters=20),
        out_layout=out_layout, scan_cap=scan_cap,
        **dict(TILED, tile_x=tile_x))
    assert enh is None and n == n_j == len(CODES)
    seg = seg.numpy()
    if out_layout == "xzy":
        seg = seg.transpose(0, 2, 1)
    # identical labels: CPU sums are sequential on both sides, and a
    # margin wider than any cell makes the tiling exact
    np.testing.assert_array_equal(seg, seg_j)
    if tile_x == 36:
        both = (seg[71] > 0) & (seg[71] == seg[72])
        assert both.sum() > 10


def test_boundary_pair_codes_matches_jax_random_case():
    rng = np.random.RandomState(3)
    tile_cap = 64
    tiles = [rng.randint(0, 9, (5, 12, 16)).astype(np.int32)
             for _ in range(3)]
    planes = rng.randint(0, 5, (3, 2, 12, 16)).astype(np.int32)
    codes_j, n_j = jseg3d._boundary_pair_codes(
        tuple(jnp.asarray(t) for t in tiles), jnp.asarray(planes), tile_cap,
        32)
    codes_j, n_j = np.asarray(codes_j), np.asarray(n_j)
    out = tseg3d._boundary_pair_codes(
        [torch.from_numpy(t) for t in tiles],
        [torch.from_numpy(p) for p in planes], tile_cap)
    assert len(out) == 2
    for t in range(2):
        assert len(out[t]) == n_j[t] > 0
        np.testing.assert_array_equal(
            out[t].numpy(), np.sort(codes_j[t][codes_j[t] > 0]))


def test_kmeans1d_centers_multi_matches_jax():
    rng = np.random.RandomState(4)
    v = np.concatenate([rng.gamma(2.0, 0.05, 600_000),
                        rng.normal(0.5, 0.05, 30_000),
                        rng.normal(0.9, 0.05, 20_000)]).astype(np.float32)
    ref = jkm.kmeans1d_centers_multi(jnp.asarray(v), (2, 3), 40)
    out = tkm.kmeans1d_centers_multi(torch.from_numpy(v), (2, 3), 40)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        np.testing.assert_allclose(
            a.numpy(), tkm.kmeans1d_centers(torch.from_numpy(v), len(a),
                                            40).numpy(), rtol=0)


def _blobs(shape, seed):
    rng = np.random.RandomState(seed)
    grids = np.mgrid[tuple(slice(0, s) for s in shape)].astype(np.float32)
    vol = np.zeros(shape, np.float32)
    for _ in range(10):
        c = [rng.uniform(3, s - 3) for s in shape]
        vol += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / 8.0)
    return vol + 0.01 * rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shift", [(0, 0, 0), (2, -1, 1), (-3, 0, 2)])
def test_register_translation_3d_matches_jax(shift):
    ref = _blobs((24, 32, 16), 0)
    mov = np.roll(ref, shift, axis=(0, 1, 2))
    sj = np.asarray(jreg.register_translation_3d(jnp.asarray(ref),
                                                 jnp.asarray(mov)))
    st = treg.register_translation_3d(torch.from_numpy(ref),
                                      torch.from_numpy(mov)).numpy()
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(st, -np.asarray(shift, np.float32))


@pytest.mark.parametrize("misaligned", [False, True])
def test_stitch_tiles_device_matches_jax(misaligned):
    spec = j3.VolumeSpec(shape=(180, 180, 40), spacing=(45, 45, 40),
                         jitter=(3., 3., 3.), semi_axes_lo=(10., 6., 8.),
                         semi_axes_hi=(12., 8., 10.), seed=3)
    lut = np.stack([jsynthetic.barcode_spectrum(JSEVEN_BIT, c)
                    for c in range(1, 64)])
    vol = np.array(j3.build_sum_volume(spec, 63, lut.sum(axis=1), seed=1,
                                       z_chunk=16))
    tiles = [vol[i * 70:i * 70 + 110, j * 70:j * 70 + 110]
             for i in range(2) for j in range(2)]
    masks, pad = None, 4
    if misaligned:
        shifts = [(0, 0, 0), (2, -1, 1), (-1, 2, 0), (1, 1, -1)]
        tiles = [np.roll(t, s, axis=(0, 1, 2)) for t, s in zip(tiles, shifts)]
        masks = []
        for s in shifts:
            m = np.ones((110, 110, 40), np.float32)
            for ax, sh in enumerate(s):
                sl = [slice(None)] * 3
                if sh:
                    sl[ax] = slice(0, sh) if sh > 0 else slice(sh, None)
                    m[tuple(sl)] = 0.0
            masks.append(m)
        pad = 6
    ref = np.asarray(jseg3d.stitch_tiles_device(
        [jnp.asarray(t) for t in tiles], (2, 2), 40, (180, 180, 40), pad=pad,
        tile_masks=masks))
    out = tseg3d.stitch_tiles_device(
        [torch.from_numpy(t) for t in tiles], (2, 2), 40, (180, 180, 40),
        pad=pad, tile_masks=masks).numpy()
    # the blend divides the same sums by the same counts
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    inner = out[pad:pad + 180, pad:pad + 180, pad:pad + 40]
    if not misaligned:
        np.testing.assert_array_equal(inner, vol)
    else:
        core = (slice(12, 168), slice(12, 168), slice(4, 36))
        assert np.abs(inner[core] - vol[core]).max() < 1e-5


@pytest.fixture(scope="module")
def spectra_truth():
    """Analytic truth of a 180^2 x 40 volume and one (X, Y, Z, 63) draw of
    its spectral data, handed to both packages."""
    spec = j3.VolumeSpec(shape=(180, 180, 40), spacing=(45, 45, 40),
                         jitter=(3., 3., 3.), semi_axes_lo=(10., 6., 8.),
                         semi_axes_hi=(12., 8., 10.), seed=3)
    lut = np.stack([jsynthetic.barcode_spectrum(JSEVEN_BIT, c)
                    for c in range(1, 64)]).astype(np.float32)
    truth, _, _ = j3.truth_chunk(spec, 63, 0, 40)
    import jax

    data = np.asarray(j3.channel_chunk(spec, 63, 0, 40, jnp.asarray(lut),
                                       jax.random.PRNGKey(1)))
    return spec, lut, np.asarray(truth), data


def test_measure_volume_streamed_matches_jax(spectra_truth):
    spec, lut, truth, data = spectra_truth
    cm = np.ascontiguousarray(data.transpose(3, 2, 0, 1))   # (C, Z, X, Y)
    ref = np.asarray(jseg3d.measure_volume_streamed(
        jnp.asarray(truth), lambda z0, zc: jnp.asarray(data[:, :, z0:z0 + zc]),
        40, 16, 63, 64))
    seg = torch.from_numpy(truth)
    out = tseg3d.measure_volume_streamed(
        seg, lambda z0, zc: torch.from_numpy(data[:, :, z0:z0 + zc]), 40, 16,
        63, 64).numpy()
    out_cm = tseg3d.measure_volume_streamed(
        seg, lambda z0, zc: torch.from_numpy(cm[:, z0:z0 + zc]), 40, 16, 63,
        64, channels_major=True).numpy()
    n = spec.n_cells
    # labels >= 1: the reference's CPU scatter also averages label 0
    for o in (out, out_cm):
        np.testing.assert_allclose(o[1:n + 1], ref[1:n + 1], rtol=1e-5,
                                   atol=1e-6)
        assert (o[n + 1:] == 0).all() and (o[0] == 0).all()
    node_code = j3.node_codes(spec, 63)
    lut_n = lut / np.linalg.norm(lut, axis=1, keepdims=True)
    for cell in range(1, n + 1):
        assert int(np.argmax(lut_n @ out_cm[cell])) == int(node_code[cell - 1])


def test_make_fused_measure_matches_jax_interpret(spectra_truth):
    spec, _, truth, data = spectra_truth
    # (Z, X, Y) labels; 3 planes of the volume keep interpret mode quick
    seg_zxy = np.ascontiguousarray(truth.transpose(2, 0, 1))[18:21]
    cm = np.ascontiguousarray(data.transpose(3, 2, 0, 1))[:, 18:21]
    shape = (180, 180, 3)
    ref, spill = jseg3d.make_fused_measure(
        lambda z0, zc: jax_slice(cm, z0, zc), shape, 2, 63, 64,
        interpret=True)(jnp.asarray(seg_zxy))
    assert not bool(spill)
    out, spilled = tseg3d.make_fused_measure(
        lambda z0, zc: torch.from_numpy(cm[:, z0:z0 + zc]), shape, 2, 63,
        64)(torch.from_numpy(seg_zxy))
    assert spilled is False
    ref = np.asarray(ref)
    present = np.unique(seg_zxy[seg_zxy > 0])
    assert len(present) >= 4
    np.testing.assert_allclose(out.numpy()[present], ref[present],
                               rtol=2.0 ** -16, atol=1e-6)


def jax_slice(cm, z0, zc):
    import jax

    return jax.lax.dynamic_slice_in_dim(jnp.asarray(cm), z0, zc, 1)


def test_volume_slice_matches_jax(volume, jax_tiled):
    """The whole slice on the 144 x 96 x 40 volume: tiled segmentation ->
    channels-major streamed measurement -> classification with the
    committed 127-code classifier, port vs JAX, and the calls are the
    planted barcodes."""
    cube, truth, vol_sum = volume
    seg_j, n = jax_tiled
    cm = np.ascontiguousarray(cube.transpose(3, 2, 0, 1))    # (C, Z, X, Y)
    avg_j = jseg3d.measure_volume_streamed(
        jnp.asarray(seg_j), lambda z0, zc: jnp.asarray(cm[:, z0:z0 + zc]),
        40, 8, 63, 64, channels_major=True)
    norm_j = avg_j / jnp.maximum(jnp.max(avg_j, axis=1, keepdims=True),
                                 1e-12)
    ja, js = jfused.classifier_to_device_args(jload(FIXTURE))
    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = js
    ci_j, _ = jfused.classify_capped(
        norm_j, jnp.int32(n), None, ja["check_params"], check_blocks, None,
        None, ja["train_features"], ja["train_labels"], n_classes, blocks,
        check_slice, n_channels, k, temperature)

    seg, n_t, _ = tseg3d.segment_3d_tiled(
        torch.from_numpy(vol_sum.copy()), SegmentationConfig(kmeans_iters=20),
        out_layout="xzy", **TILED)
    run = tseg3d.make_fused_measure(
        lambda z0, zc: torch.from_numpy(cm[:, z0:z0 + zc]), vol_sum.shape, 8,
        63, 64)
    avg, _ = run(seg.permute(1, 0, 2).contiguous())
    norm = avg / torch.clamp(torch.max(avg, dim=1, keepdim=True).values,
                             min=1e-12)
    ta, ts = tfused.classifier_from_numpy(tload(FIXTURE), "cpu")
    ci, _ = tfused.classify_device(norm, ta["check_heads"], ts[6], None,
                                   None, ta["train_features"],
                                   ta["train_labels"], *ts[:6])
    assert n_t == n
    np.testing.assert_allclose(avg.numpy()[1:n + 1],
                               np.asarray(avg_j)[1:n + 1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(ci.numpy()[1:n + 1],
                                  np.asarray(ci_j)[1:n + 1])
    # each found cell is called as the barcode planted where it lies
    codebook = list(tload(FIXTURE).codebook)
    seg_xyz = seg.permute(0, 2, 1).numpy()
    for cell in range(1, n + 1):
        planted = np.bincount(truth[seg_xyz == cell]).argmax()
        assert codebook[int(ci[cell])] == \
            JSEVEN_BIT.code_str(CODES[planted - 1])


def test_classify_device_matches_build_features_and_predict():
    # the 3D path's classification: the port's classify_device equals the
    # reference classifier's build_features + predict_with_proba for the
    # 7-bit layout (no derivative features)
    jclf = jload(FIXTURE)
    assert not jclf.violet_derivative and not jclf.full_derivative
    rng = np.random.RandomState(6)
    lut = jsynthetic.fluorophore_spectra(JSEVEN_BIT)
    rows = np.stack([jsynthetic.barcode_spectrum(JSEVEN_BIT, 1 + 5 * i % 127,
                                                 lut) for i in range(48)])
    rows = np.clip(rows * rng.uniform(0.7, 1.3, (48, 1))
                   + rng.randn(48, 63) * 0.02, 0, None).astype(np.float32)
    rows /= np.maximum(rows.max(axis=1, keepdims=True), 1e-12)
    rows[0] = 0.0
    pred_j, mp_j, _ = jclf.predict_with_proba(
        jclf.build_features(jnp.asarray(rows)))
    ta, ts = tfused.classifier_from_numpy(tload(FIXTURE), "cpu")
    pred, mp = tfused.classify_device(
        torch.from_numpy(rows), ta["check_heads"], ts[6], None, None,
        ta["train_features"], ta["train_labels"], *ts[:6])
    np.testing.assert_array_equal(pred.numpy(), np.asarray(pred_j))
    np.testing.assert_allclose(mp.numpy(), np.asarray(mp_j), rtol=1e-5)
