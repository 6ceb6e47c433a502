"""Port parity: 2D LP-CV (kernel B2's plain version) and its offset table
vs the JAX package on the CPU."""

import re
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


def test_kernel_line_table_equal():
    # kernel B2 holds the patch=11, phi=9 table as constants in its source
    src = (Path(tlp.__file__).parent.parent / "csrc" / "lpcv2d.cu") \
        .read_text()
    body = re.search(r"kLine\[PHI\]\[PATCH\]\[2\] = \{(.*?)\};", src,
                     re.S).group(1)
    table = np.array([int(v) for v in re.findall(r"-?\d+", body)])
    np.testing.assert_array_equal(table.reshape(9, 11, 2),
                                  jlp.line_table_2d(11, 9))


def test_line_table_t9_quartile_ranks_exact():
    # T = 9 orientations: the 25th/75th percentiles fall on ranks 2 and 6
    # exactly, which the kernel takes without interpolation
    assert 0.25 * (9 - 1) == 2.0 and 0.75 * (9 - 1) == 6.0


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_lp_cv_enhance_2d_plain_matches_jax(kind):
    rng = np.random.RandomState(3)
    if kind == "noise":
        img = rng.rand(64, 96).astype(np.float32)
    else:
        yy, xx = np.mgrid[:64, :96].astype(np.float32)
        img = (0.5 + 0.3 * np.sin(yy / 7.0) * np.cos(xx / 5.0)
               + 0.01 * rng.randn(64, 96)).astype(np.float32)
    ref = np.asarray(jlp.lp_cv_enhance_2d(jnp.asarray(img), 11, 9))
    out = tlp.lp_cv_enhance_2d(torch.from_numpy(img), 11, 9).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
