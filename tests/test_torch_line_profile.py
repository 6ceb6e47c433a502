"""Port parity: 2D LP-CV (kernel B2's plain version) and its offset table
vs the JAX package on the CPU."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import line_profile as jlp
from hiprfish_tpu_torch.ops import line_profile as tlp

torch.set_num_threads(1)


@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5), (11, 4)])
def test_line_table_2d_equal(patch, phi):
    np.testing.assert_array_equal(tlp.line_table_2d(patch, phi),
                                  jlp.line_table_2d(patch, phi))


@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5), (15, 12)])
def test_kernel_line_table_equal(patch, phi):
    # kernel B2 takes its line table as an argument: the wrapper hands it
    # the (cached) line_table_2d of the stencil asked for; stencils up to
    # (11, 9) travel in the launch parameters, larger ones in device memory
    np.testing.assert_array_equal(tlp._line_table_2d_cached(patch, phi),
                                  jlp.line_table_2d(patch, phi))
    src = (Path(tlp.__file__).parent.parent / "csrc" / "lpcv2d.cu") \
        .read_text()
    assert "constexpr int SPHI = 9;" in src
    assert "constexpr int SPATCH = 11;" in src


def test_line_table_t9_quartile_ranks_exact():
    # T = 9 orientations: the 25th/75th percentiles fall on ranks 2 and 6
    # exactly, which the kernel takes without interpolation
    assert 0.25 * (9 - 1) == 2.0 and 0.75 * (9 - 1) == 6.0


# (7, 5) and (15, 12) are stencils kernel B2 takes besides the default:
# the first in its launch parameters, the second (interpolated quartiles)
# from device memory
@pytest.mark.parametrize("kind,patch,phi", [
    ("noise", 11, 9), ("smooth", 11, 9), ("smooth", 7, 5),
    ("smooth", 15, 12)])
def test_lp_cv_enhance_2d_plain_matches_jax(kind, patch, phi):
    rng = np.random.RandomState(3)
    if kind == "noise":
        img = rng.rand(64, 96).astype(np.float32)
    else:
        yy, xx = np.mgrid[:64, :96].astype(np.float32)
        img = (0.5 + 0.3 * np.sin(yy / 7.0) * np.cos(xx / 5.0)
               + 0.01 * rng.randn(64, 96)).astype(np.float32)
    ref = np.asarray(jlp.lp_cv_enhance_2d(jnp.asarray(img), patch, phi))
    out = tlp.lp_cv_enhance_2d(torch.from_numpy(img), patch, phi).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
