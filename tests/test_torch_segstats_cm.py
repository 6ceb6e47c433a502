"""Port parity: the channels-major per-label stats (kernel B5's plain
version) vs the JAX package's stats_cm_pallas in interpret mode on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import segstats_pallas as sp
from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.ops import segstats as tseg

torch.set_num_threads(1)

NSEG = 128


def _planes(n_planes, h, w, seed):
    """Per-plane raster-ordered blocky labels: ids ascend along each plane
    (band-local, as ranked cell ids are), each plane restarting near 1."""
    rng = np.random.RandomState(seed)
    lab = np.zeros((n_planes, h, w), np.int32)
    for p in range(n_planes):
        nid = 1 + 3 * p
        for r in range(0, h, 6):
            for c in range(0, w, 10):
                if rng.rand() < 0.8:
                    lab[p, r:r + rng.randint(2, 6), c:c + rng.randint(3, 10)] \
                        = nid
                nid += 1
    return lab


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_planes", [1, 3])
def test_stats_cm_matches_pallas_interpret(dtype, n_planes):
    lab = _planes(n_planes, 24, 40, n_planes)
    assert lab.max() < NSEG
    img = np.random.RandomState(5).rand(6, n_planes, 24, 40) \
        .astype(np.float32)
    timg = torch.from_numpy(img).to(getattr(torch, dtype))
    # the reference's interpret mode has no bf16 x bf16 dot on the CPU; the
    # bf16-rounded values in f32 give its bf16 arithmetic (hi part exact,
    # lo part zero)
    ref_img = timg.to(torch.float32).numpy()
    ref, spill = sp.stats_cm_pallas(jnp.asarray(lab), jnp.asarray(ref_img),
                                    NSEG, 64, 256, n_planes, True)
    assert not bool(spill)
    ref = np.asarray(ref)
    out = tseg.stats_cm(torch.from_numpy(lab), timg, NSEG)
    assert out.shape == (NSEG, 7)
    out = out.numpy()
    # row 0 is background: zero here, not meaningful in the reference
    assert (out[0] == 0).all()
    np.testing.assert_array_equal(out[1:, 0], ref[1:, 0])
    # the reference's f32 path is a bf16 hi/lo split: 2^-16 relative
    np.testing.assert_allclose(out[1:, 1:], ref[1:, 1:], rtol=2.0 ** -16,
                               atol=1e-6)
    assert out[1:, 0].sum() == (lab > 0).sum()


def test_stats_cm_skips_out_of_range_ids():
    lab = np.array([[0, 1, 1, 7, 8, -2, 3]], np.int32)
    img = np.arange(14, dtype=np.float32).reshape(2, 1, 7)
    acc = tseg.stats_cm(torch.from_numpy(lab), torch.from_numpy(img), 8)
    np.testing.assert_array_equal(acc[:, 0].numpy(),
                                  [0, 2, 0, 1, 0, 0, 0, 1])
    np.testing.assert_array_equal(acc[1].numpy(), [2, 1 + 2, 8 + 9])
    np.testing.assert_array_equal(acc[7].numpy(), [1, 3, 10])


def test_stats_cm_takes_plain_on_cpu():
    lab = torch.from_numpy(_planes(2, 12, 20, 0))
    img = torch.ones((3, 2, 12, 20))
    before = kernels.launch_counts()
    acc = tseg.stats_cm(lab, img, NSEG)
    assert kernels.launch_counts() == before
    torch.testing.assert_close(acc[:, 1], acc[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        tseg.stats_cm(lab.to("meta"), img.to("meta"), NSEG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_cm_adds_into_a_caller_table(dtype):
    # the streamed measurement's form: one table, each slab added in place,
    # equal to the sum of the slabs' own tables
    lab = torch.from_numpy(_planes(4, 12, 20, 3))
    img = torch.from_numpy(np.random.RandomState(6).rand(5, 4, 12, 20)
                           .astype(np.float32)).to(dtype)
    acc = torch.zeros((NSEG, 6))
    want = torch.zeros((NSEG, 6))
    for z0 in (0, 2):
        got = tseg.stats_cm(lab[z0:z0 + 2], img[:, z0:z0 + 2], NSEG, out=acc)
        assert got is acc
        want += tseg.stats_cm(lab[z0:z0 + 2], img[:, z0:z0 + 2], NSEG)
    torch.testing.assert_close(acc, want, rtol=0, atol=0)


def test_fused_measure_accumulates_in_place():
    from hiprfish_tpu_torch.pipeline import segment3d

    lab = torch.from_numpy(_planes(5, 12, 20, 4))          # (Z, X, Y)
    img = torch.from_numpy(np.random.RandomState(7).rand(3, 5, 12, 20)
                           .astype(np.float32))             # (C, Z, X, Y)
    run = segment3d.make_fused_measure(
        lambda z0, zc: img[:, z0:z0 + zc], (12, 20, 5), 2, 3, NSEG)
    avg, spill = run(lab)
    tot = tseg.stats_cm(lab, img, NSEG)
    assert not spill
    torch.testing.assert_close(
        avg, tot[:, 1:] / torch.clamp(tot[:, :1], min=1.0), rtol=1e-6,
        atol=1e-7)
