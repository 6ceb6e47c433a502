"""The port's synthetic 3D volume generator vs the JAX package's: the
integer-hash geometry ports exactly; the noise comes from torch
generators (other bits than jax.random, same distribution)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.utils import synthetic3d as j3
from hiprfish_tpu_torch.config import SEVEN_BIT
from hiprfish_tpu_torch.utils import synthetic, synthetic3d as t3

torch.set_num_threads(1)

SPECS = [
    dict(shape=(180, 180, 40), spacing=(45, 45, 40), jitter=(3., 3., 3.),
         semi_axes_lo=(10., 6., 8.), semi_axes_hi=(12., 8., 10.), seed=3),
    # the full-size volume's defaults (seed 5), cut to 256 x 256 x 104
    dict(shape=(256, 256, 104), seed=5),
]


@pytest.mark.parametrize("kw,z0,zc", [(SPECS[0], 0, 16), (SPECS[0], 24, 16),
                                      (SPECS[1], 8, 40)])
def test_truth_chunk_equal(kw, z0, zc):
    ref = j3.truth_chunk(j3.VolumeSpec(**kw), 127, z0, zc)
    out = t3.truth_chunk(t3.VolumeSpec(**kw), 127, z0, zc, "cpu")
    labels, codes, profile = (np.asarray(a) for a in ref)
    assert (labels > 0).any()
    np.testing.assert_array_equal(out[0].numpy(), labels)
    np.testing.assert_array_equal(out[1].numpy(), codes)
    # cos/sin/sqrt of f32 differ by an ulp between the two libraries
    np.testing.assert_allclose(out[2].numpy(), profile, rtol=0, atol=5e-7)


@pytest.mark.parametrize("kw", SPECS)
def test_node_codes_equal(kw):
    ref = j3.node_codes(j3.VolumeSpec(**kw), 127)
    out = t3.node_codes(t3.VolumeSpec(**kw), 127)
    np.testing.assert_array_equal(out, ref)
    assert t3.VolumeSpec(**kw).n_cells == j3.VolumeSpec(**kw).n_cells


def test_hash_wraps_like_uint32():
    # 0xFFFFFFFF * 0x846CA68B passes 2^63 in int64; the low 32 bits must
    # still be the uint32 product's
    v = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 123456789, 4000000000],
                 np.int64)
    for salt in (0, 12, 0xFFFFFFFF):
        ref = np.asarray(j3._hash_u32(*(jnp.asarray(v.astype(np.uint32)),)
                                      * 3, salt))
        out = t3._hash_u32(*(torch.from_numpy(v),) * 3, salt).numpy()
        np.testing.assert_array_equal(out, ref.astype(np.int64))


def test_channel_and_sum_chunks():
    spec = t3.VolumeSpec(**SPECS[0])
    codes = list(range(1, 64))
    lut = np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c) for c in codes])
    lut_t = torch.from_numpy(lut.astype(np.float32))
    labels, code_idx, profile = t3.truth_chunk(spec, 63, 8, 4, "cpu")
    cm = t3.channel_chunk_cm(spec, 63, 8, 4, lut_t, seed=1)
    assert cm.shape == (63, 4, 180, 180) and cm.dtype == torch.float32
    noise = cm - (lut_t.T[:, code_idx.long()] * profile).permute(0, 3, 1, 2)
    assert 0.0 <= float(noise.min()) and float(noise.max()) < spec.noise
    assert abs(float(noise.mean()) - spec.noise / 2) < 1e-3
    # the same slab again: the same generator bits
    torch.testing.assert_close(t3.channel_chunk_cm(spec, 63, 8, 4, lut_t, 1),
                               cm, rtol=0, atol=0)
    bf = t3.channel_chunk_cm(spec, 63, 8, 4, lut_t, 1, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.float(), cm, rtol=2.0 ** -8, atol=0)
    vol = t3.build_sum_volume(spec, 63, lut.sum(axis=1), seed=1, z_chunk=16,
                              device="cpu")
    assert vol.shape == (180, 180, 40)
    s = t3.sum_chunk(spec, 63, 16, 16, torch.from_numpy(
        lut.sum(axis=1).astype(np.float32)), 1)
    torch.testing.assert_close(vol[:, :, 16:32], s, rtol=0, atol=0)
    inside = t3.truth_chunk(spec, 63, 16, 16, "cpu")[0] > 0
    assert float(s[inside].mean()) > 10 * float(s[~inside].mean())
