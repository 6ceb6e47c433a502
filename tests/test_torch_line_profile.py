"""Port parity: 2D LP-CV (kernel B2's plain version) and its offset table,
and the stencil forms line_profile_2d, line_profile_3d,
line_profile_3d_full and neighbor_average, vs the JAX package on the
CPU (and line_profile_2d vs the reference oracle's Cython transcription).
"""

from pathlib import Path

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import line_profile as jlp
from hiprfish_tpu.ops import lp3d_pallas
from hiprfish_tpu_torch.ops import line_profile as tlp
from ref_oracle.lp2d import line_profile_2d_v2 as lp_oracle

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


def _padded(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5), (15, 12)])
def test_line_profile_2d_equals_jax_and_oracle(patch, phi):
    img = _padded((30 + patch - 1, 41 + patch - 1), 1)
    out = tlp.line_profile_2d(torch.from_numpy(img), patch, phi).numpy()
    ref = np.asarray(jlp.line_profile_2d(jnp.asarray(img), patch, phi))
    assert out.shape == (30, 41, phi, patch) and out.dtype == np.float32
    # a gather: bitwise
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, lp_oracle(img, patch, phi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", [(11, 9, 9), (7, 5, 6)])
def test_line_profile_3d_equals_jax(dtype, cfg):
    vol = _padded((12 + cfg[0] - 1, 9 + cfg[0] - 1, 6 + cfg[0] - 1), 2)
    t = torch.from_numpy(vol).to(dtype)
    j = jnp.asarray(vol).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                else jnp.float32)
    out = tlp.line_profile_3d(t, *cfg).numpy()
    ref = np.asarray(jlp.line_profile_3d(j, *cfg))
    assert out.shape == (12, 9, 6, (cfg[1] - 1) * cfg[2])
    assert out.dtype == ref.dtype == np.float32
    # min and max in the input's precision, the ratio in f32
    np.testing.assert_array_max_ulp(out, ref, 1)


def test_line_profile_3d_full_equals_jax():
    vol = _padded((18, 17, 16), 3)
    out = tlp.line_profile_3d_full(torch.from_numpy(vol)).numpy()
    ref = np.asarray(jlp.line_profile_3d_full(jnp.asarray(vol)))
    assert out.shape == (8, 7, 6, 72, 11)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("patch", [11, 5])
def test_neighbor_average_equals_jax(patch):
    vol = _padded((30 + 2 * (patch - 1), 23 + 2 * (patch - 1),
                   19 + 2 * (patch - 1)), 4)
    out = tlp.neighbor_average(torch.from_numpy(vol), patch).numpy()
    ref = np.asarray(jlp.neighbor_average(jnp.asarray(vol), patch))
    assert out.shape == (30, 23, 19, patch - 1)
    # the reference CPU program's cumulative sums and its multiply by the
    # f32 reciprocal of each box's size: bitwise
    np.testing.assert_array_equal(out, ref)


def test_stencil_forms_combine_to_the_enhancement():
    # _lp_cv_combine of the centre-normalised profiles is the 3D LP-CV;
    # of the 2D profiles' normalised centres, the 2D one
    vol = _padded((14, 12, 10), 5)
    t = torch.from_numpy(vol)
    pad = torch.nn.functional.pad(t[None, None], (5,) * 6,
                                  mode="replicate")[0, 0]
    np.testing.assert_allclose(
        tlp._lp_cv_combine(tlp.line_profile_3d(pad)).numpy(),
        tlp.lp_cv_enhance_3d_plain(t).numpy(), rtol=0, atol=1e-6)
    img = torch.from_numpy(_padded((40, 33), 6))
    prof = tlp.line_profile_2d(torch.nn.functional.pad(
        img[None, None], (5,) * 4, mode="replicate")[0, 0])
    lo, hi = prof.min(dim=-1).values, prof.max(dim=-1).values
    rnc = (prof[..., 5] - lo) / torch.clamp(hi - lo, min=1e-8)
    np.testing.assert_allclose(tlp._lp_cv_combine(rnc).numpy(),
                               tlp.lp_cv_enhance_2d_plain(img).numpy(),
                               rtol=0, atol=1e-6)
