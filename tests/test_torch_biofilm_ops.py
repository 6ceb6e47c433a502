"""Port parity for the ops of the biofilm slice, each on numpy inputs made
from a seed, against the JAX package on the CPU: disk morphology by FFT,
the cross closing, the Sobel magnitude, per-label maxima and overlap,
the KMeans labels, 2D stack and 3D volume registration, and the
probe-design and z-stack readers. Exactly equal unless a tolerance is
named."""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.io import images as jimages
from hiprfish_tpu.io import tables as jtables
from hiprfish_tpu.ops import kmeans as jkm
from hiprfish_tpu.ops import morphology as jmorph
from hiprfish_tpu.ops import regionprops as jrp
from hiprfish_tpu.ops import register as jreg
from hiprfish_tpu.pipeline import segment3d as jseg3d
from hiprfish_tpu_torch.io import images, tables
from hiprfish_tpu_torch.ops import fp
from hiprfish_tpu_torch.ops import kmeans as km
from hiprfish_tpu_torch.ops import morphology as morph
from hiprfish_tpu_torch.ops import regionprops as rp
from hiprfish_tpu_torch.ops import register as reg
from hiprfish_tpu_torch.pipeline import segment3d as seg3d
from tests.test_torch_segment3d import _volume_stack

torch.set_num_threads(1)


def _mask(shape, seed, p=0.08):
    """Random blobs: sparse seeds grown by one cross dilation."""
    rng = np.random.RandomState(seed)
    m = rng.rand(*shape) < p
    return np.array(jmorph.binary_dilation(jnp.asarray(m)))


@pytest.mark.parametrize("radius", [0, 1, 3, 8, 100])
def test_disk_kernel_equals_jax(radius):
    k = morph.disk_kernel(radius)
    assert k.dtype == np.float32
    np.testing.assert_array_equal(k, jmorph.disk_kernel(radius))


@pytest.mark.parametrize("radius", [3, 8])
@pytest.mark.parametrize("op", ["binary_dilation_disk", "binary_erosion_disk",
                                "binary_closing_disk"])
def test_disk_morphology_equals_jax(op, radius):
    m = _mask((96, 128), seed=radius, p=0.2 / (1 + radius * radius))
    if op == "binary_erosion_disk":
        m = ~m
    got = getattr(morph, op)(torch.from_numpy(m), radius)
    want = np.asarray(getattr(jmorph, op)(jnp.asarray(m), radius))
    assert got.dtype == torch.bool
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)


def test_disk_morphology_radius_100_equals_jax():
    """The default epithelial radius on one 256^2 mask: counts up to ~31,400
    against the 0.5 threshold."""
    m = _mask((256, 256), seed=11, p=0.002)
    for op in ("binary_dilation_disk", "binary_erosion_disk",
               "binary_closing_disk"):
        got = getattr(morph, op)(torch.from_numpy(m), 100).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jmorph, op)(jnp.asarray(m), 100)), op)


@pytest.mark.parametrize("seed", [0, 1])
def test_binary_closing_equals_jax(seed):
    m = np.random.RandomState(seed).rand(40, 56) < 0.4
    np.testing.assert_array_equal(
        morph.binary_closing(torch.from_numpy(m)).numpy(),
        np.asarray(jmorph.binary_closing(jnp.asarray(m))))


def test_sobel_magnitude_equals_jax():
    img = np.random.RandomState(3).rand(48, 72).astype(np.float32)
    got = morph.sobel_magnitude(torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmorph.sobel_magnitude(img)),
                               rtol=1e-6, atol=0)


def test_max_intensities_equals_jax():
    """Empty labels give -inf; labels past num_segments and negative ones
    are dropped, as jax.ops.segment_max drops them."""
    rng = np.random.RandomState(4)
    labels = rng.randint(0, 12, (30, 40)).astype(np.int32)
    labels[labels == 5] = 7          # label 5 empty
    labels[0, :6] = 20               # past num_segments
    labels[1, :3] = -2
    image = rng.randn(30, 40, 3).astype(np.float32)
    got = rp.max_intensities(torch.from_numpy(labels),
                             torch.from_numpy(image), 12).numpy()
    want = np.asarray(jrp.max_intensities(labels, image, 12))
    assert np.isneginf(want[5]).all()
    np.testing.assert_array_equal(got, want)


def test_fixed_point_segment_sum_is_order_free(monkeypatch):
    """The card's per-label channel sums: the same bits for any row order,
    each within one f32 rounding (plus the fixed-point step) of the exact
    sum; a zero column and ids out of range included."""
    rng = np.random.RandomState(10)
    n, k, segs = 5000, 6, 33
    vals = (rng.rand(n, k) ** 3 * np.array([1, 1e-3, 50, 1, 0, 2])) \
        .astype(np.float32)
    ids = rng.randint(-1, 40, n)
    perm = rng.permutation(n)
    cnt2, again = fp.fixed_point_sums(torch.from_numpy(vals[perm]),
                                      torch.from_numpy(ids[perm]), segs)
    # the rows quantised 1000 at a time give the same bits
    monkeypatch.setattr(fp, "FIXED_POINT_CHUNK", 1000)
    cnt, got = fp.fixed_point_sums(torch.from_numpy(vals),
                                   torch.from_numpy(ids), segs)
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert torch.equal(cnt, cnt2)
    keep = (ids >= 0) & (ids < segs)
    exact = np.zeros((segs, k))
    np.add.at(exact, ids[keep], vals[keep].astype(np.float64))
    counts = np.bincount(ids[keep], minlength=segs)[:, None]
    np.testing.assert_array_equal(cnt.numpy(), counts[:, 0])
    step = vals.max(axis=0) * 2.0 ** -(62 - n.bit_length() + 1)
    tol = np.spacing(np.abs(exact).astype(np.float32)) + counts * step
    assert (np.abs(got.numpy() - exact) <= tol).all()
    assert (got.numpy()[:, 4] == 0).all()


def test_fp_exp_equals_jax_and_flushes_without_the_global_flag():
    """fp.exp, which the NL-means twin calls on every device, gives the
    reference CPU program's bits, down to its denormals flushed to 0,
    and leaves the process's denormal mode as it was."""
    x = np.concatenate([np.linspace(-90.0, 5.0, 20001),
                        np.linspace(-87.6, -86.9, 2001)]).astype(np.float32)
    got = fp.exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.exp(jnp.asarray(x))))
    assert (got[(got != 0)] >= np.finfo(np.float32).tiny).all()
    assert (got == 0).any()
    assert float(torch.tensor(np.float32(1e-38)) * 0.5) != 0.0


def test_label_overlap_any_equals_jax():
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 10, (30, 40)).astype(np.int32)
    labels[2, :4] = 15
    mask = rng.rand(30, 40) < 0.02
    got = rp.label_overlap_any(torch.from_numpy(labels),
                               torch.from_numpy(mask), 10).numpy()
    want = np.asarray(jrp.label_overlap_any(labels, mask, 10))
    assert 0 < want.sum() < 10
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 3])
def test_kmeans1d_equals_jax(k):
    """Labels (nearest centre, the lower index on a tie) and centres, on
    log10 intensities: the biofilm background's negative range. The
    centres are within rtol 1e-6, as tests/test_torch_kmeans.py holds
    them (the Lloyd sums add in another order)."""
    rng = np.random.RandomState(k)
    v = np.log10(np.concatenate([rng.rand(3000) * 0.05, 0.4 + rng.rand(900)])
                 .astype(np.float32) + np.float32(1e-8)).reshape(60, 65)
    labels, centers = km.kmeans1d(torch.from_numpy(v), k)
    jl, jc = jkm.kmeans1d(jnp.asarray(v), k)
    np.testing.assert_allclose(centers.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    dark = km.darkest_cluster_mask(torch.from_numpy(v), k)
    np.testing.assert_array_equal(
        dark.numpy(), np.asarray(jkm.darkest_cluster_mask(jnp.asarray(v), k)))


def test_fixed_point_bin_sums_on_a_negative_range():
    """The card's order-free bin sums on a negative range (log10 of the
    denoised image, about [-8, 0]): the counts of the f32 bins, each sum
    within one f32 rounding (plus the fixed-point step) of the exact sum,
    and the Lloyd centres from those bins give the JAX package's threshold
    mask."""
    rng = np.random.RandomState(8)
    v = torch.from_numpy(np.log10(rng.rand(20000).astype(np.float32) ** 4
                                  + np.float32(1e-8)))
    vmin, vmax = torch.min(v), torch.max(v)
    span = torch.clamp(vmax - vmin, min=1e-12)
    idx = torch.clamp(((v - vmin) / span * 2047).to(torch.int32), 0, 2047)
    counts, sums = fp.fixed_point_sums(v[:, None], idx, 2048, span=span,
                                       offset=vmin, bits=km.FIX_BITS)
    sums = sums[:, 0]
    assert float(vmin) < -7.0
    exact = np.zeros(2048)
    np.add.at(exact, idx.numpy(), v.numpy().astype(np.float64))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(idx.numpy(), minlength=2048))
    tol = (np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
           + counts.numpy() * float(span) * 2.0 ** -41)
    assert (np.abs(sums.numpy() - exact) <= tol).all()
    ar = torch.arange(2048, dtype=torch.float32)
    bin_val = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          vmin + (ar + 0.5) / 2048 * span)
    centers = km._lloyd_from_histogram(counts, bin_val, vmin, vmax, span, 2,
                                       40)
    np.testing.assert_array_equal(
        (v >= (centers[-1] + centers[-2]) / 2.0).numpy(),
        np.asarray(jkm.brightest_cluster_mask(jnp.asarray(v.numpy()))))


@pytest.mark.parametrize("max_shift", [None, 2.5])
def test_register_stack_2d_equals_jax(max_shift):
    """Shifts of three projections against the first; the clamp zeroes
    each component past max_shift (the 4 px one) and keeps the others."""
    rng = np.random.RandomState(6)
    base = rng.rand(64, 80).astype(np.float32)
    base[20:30, 30:44] += 3.0
    sums = [base, np.roll(base, (2, -1), (0, 1)),
            np.roll(base, (-4, 2), (0, 1))]
    got = reg.register_stack_2d([torch.from_numpy(s) for s in sums],
                                max_shift)
    want = np.asarray(jreg.register_stack_2d(
        [jnp.asarray(s) for s in sums], max_shift))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[2].tolist() == ([4.0, -2.0] if max_shift is None
                                else [0.0, -2.0])


@pytest.mark.parametrize("shift", [(2, -3, 1), (-5, 0, -2), (0, 0, 0)])
def test_apply_shift_3d_equals_jax(shift):
    vol = np.random.RandomState(7).rand(12, 10, 6, 3).astype(np.float32)
    got, mask = reg.apply_shift_3d(torch.from_numpy(vol), torch.tensor(shift))
    want, jmask = jreg.apply_shift_3d(jnp.asarray(vol), jnp.asarray(shift))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_register_volume_stack_equals_jax():
    """The 144x96x40 volume of the 3D tests with lasers 2 and 3 rolled:
    the port's registration recovers the rolls as the JAX package's does."""
    cube, _ = _volume_stack([1, 9, 65, 127, 3, 5, 17, 33, 64], (144, 96, 40))
    blocks = [cube[..., lo:hi] for lo, hi in JSEVEN_BIT.blocks]
    blocks[1] = np.roll(blocks[1], (3, -2, 1), (0, 1, 2))
    blocks[2] = np.roll(blocks[2], (-1, 2, 0), (0, 1, 2))
    got = seg3d.register_volume_stack([torch.from_numpy(b) for b in blocks])
    want = np.asarray(jseg3d.register_volume_stack(blocks))
    assert got.shape == (144, 96, 40, 63)
    np.testing.assert_array_equal(got.numpy(), want)


def test_read_probe_design_equals_pandas(tmp_path):
    """A CSV that pandas wrote, with leading-zero codes, duplicate rows, a
    float column with a gap and a text column: the same columns, order,
    values and types as pandas reads them with code as text."""
    path = str(tmp_path / "probes.csv")
    pd.DataFrame({
        "target_taxon": [816, 1578, 816, 33, 1578],
        "code": ["0000001", "0010110", "0000001", "1000000", "0010110"],
        "tm": [60.5, 61.0, 60.5, np.nan, 61.0],
        "name": ["a", "b", "a", "c", "b"],
    }).to_csv(path, index=False)
    got = tables.read_probe_design(path)
    want = jtables.read_probe_design(path)
    assert list(got) == list(want.columns)
    for name in want.columns:
        col = want[name].to_numpy()
        assert got[name].dtype == col.dtype, name
        np.testing.assert_array_equal(got[name], col)
    assert got["code"][0] == "0000001"


def test_load_image_zstack_fixed_t_equals_jax(tmp_path):
    stack = np.random.RandomState(9).rand(3, 8, 10, 4).astype(np.float32)
    path = str(tmp_path / "s_488.npy")
    np.save(path, stack)
    got = images.load_image_zstack_fixed_t(path)
    assert got.shape == (8, 10, 3, 4)
    np.testing.assert_array_equal(got, jimages.load_image_zstack_fixed_t(path))
    np.save(path, stack[0])
    with pytest.raises(ValueError):
        images.load_image_zstack_fixed_t(path)
    with pytest.raises(NotImplementedError, match="§A.7"):
        images.load_image_zstack_fixed_t(os.path.join(str(tmp_path),
                                                      "s_488.czi"))
