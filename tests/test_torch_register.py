"""Port parity: FFT registration (hiprfish_tpu_torch.ops.register vs
hiprfish_tpu.ops.register) on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import register as jreg
from hiprfish_tpu_torch.ops import register as treg

torch.set_num_threads(1)


def _scene(shape, seed):
    rng = np.random.RandomState(seed)
    img = np.zeros(shape, np.float32)
    for _ in range(12):
        cy, cx = rng.uniform(8, shape[0] - 8), rng.uniform(8, shape[1] - 8)
        yy, xx = np.mgrid[:shape[0], :shape[1]]
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    return img + 0.01 * rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shift", [(0, 0), (2, -1), (0, 3), (-2, 0),
                                   (5, 7)])
def test_register_translation_integer_shifts_equal(shift):
    ref = _scene((96, 128), 0)
    mov = np.roll(ref, shift, axis=(0, 1))
    sj = np.asarray(jreg.register_translation(jnp.asarray(ref),
                                              jnp.asarray(mov)))
    st = treg.register_translation(torch.from_numpy(ref),
                                   torch.from_numpy(mov)).numpy()
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(st, -np.asarray(shift, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_shift_2d_equal(dtype):
    rng = np.random.RandomState(1)
    cube = rng.rand(40, 56, 5).astype(np.float32)
    shift = np.asarray([3.0, -4.0], np.float32)
    out_j, mask_j = jreg.apply_shift_2d(
        jnp.asarray(cube).astype(getattr(jnp, dtype)), jnp.asarray(shift))
    out_t, mask_t = treg.apply_shift_2d(
        torch.from_numpy(cube).to(getattr(torch, dtype)),
        torch.from_numpy(shift))
    assert out_t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out_t.float().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


def test_clamp_shift_equal():
    s = np.asarray([16.0, -3.0], np.float32)
    np.testing.assert_array_equal(
        treg.clamp_shift(torch.from_numpy(s), 15).numpy(),
        np.asarray(jreg.clamp_shift(jnp.asarray(s), 15)))
