"""Port parity: 2D LP-CV (kernel B2's plain version) and its offset table
vs the JAX package on the CPU."""

from pathlib import Path

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import line_profile as jlp
from hiprfish_tpu.ops import lp3d_pallas
from hiprfish_tpu_torch.ops import line_profile as tlp

torch.set_num_threads(1)


@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5), (11, 4)])
def test_line_table_2d_equal(patch, phi):
    np.testing.assert_array_equal(tlp.line_table_2d(patch, phi),
                                  jlp.line_table_2d(patch, phi))


@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5), (15, 12)])
def test_kernel_line_table_equal(patch, phi):
    # kernel B2 takes its line table as an argument: the binding hands it
    # the (cached) line_table_2d of the stencil asked for; (11, 9) travels
    # in the launch parameters, every stencil in device memory
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


# (7, 5) and (15, 12) are stencils kernel B2 takes besides the default,
# from device memory, the second with interpolated quartiles
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


# just past B2's former caps: a halo of 65 (patch 131) and 129
# orientations (ratios beyond any fixed per-thread array), both with
# interpolated quartiles
@pytest.mark.parametrize("patch,phi", [(131, 5), (11, 129)])
def test_lp_cv_enhance_2d_plain_matches_jax_large_stencils(patch, phi):
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[:40, :56].astype(np.float32)
    img = (0.5 + 0.3 * np.sin(yy / 7.0) * np.cos(xx / 5.0)
           + 0.01 * rng.randn(40, 56)).astype(np.float32)
    ref = np.asarray(jlp.lp_cv_enhance_2d(jnp.asarray(img), patch, phi))
    out = tlp.lp_cv_enhance_2d(torch.from_numpy(img), patch, phi).numpy()
    # the phi-term mean of ratios in [0, 1] summed in another order: up to
    # phi ulps of 1
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=max(1e-6, phi * 2.0 ** -24))


@pytest.mark.parametrize("patch,phi", [
    (11, 9), (7, 5), (15, 12), (131, 5), (11, 129)])
def test_every_line_holds_the_centre_as_its_middle_sample(patch, phi):
    # kernel B2 takes the centre sample once per pixel, and its (11, 9)
    # form starts each line's min and max from it and skips sample pad;
    # the plain version takes sample pad of each line
    pad = (patch - 1) // 2
    table = tlp.line_table_2d(patch, phi)
    assert (table[:, pad] == pad).all()


@pytest.mark.parametrize("macro,outputs", [("HF_LP2D_SELECT9", (2, 6))])
def test_kernel_selection_networks(macro, outputs):
    # the (11, 9) kernel's quartile network is the reference's
    # selection_network, compare-exchange for compare-exchange
    src = (Path(tlp.__file__).parent.parent / "csrc" / "lpcv2d.cu") \
        .read_text()
    lines = src[src.index(f"#define {macro}(CX)"):].splitlines()
    n = next(i for i, ln in enumerate(lines) if not ln.endswith("\\"))
    body = "\n".join(lines[:n + 1])
    pairs = [(int(a), int(b))
             for a, b in re.findall(r"CX\((\d+), (\d+)\)", body)]
    assert pairs == list(lp3d_pallas.selection_network(9, outputs))
