"""Port parity: 3D LP-CV (kernel B6's plain version) and the kernel's
committed constant tables vs the JAX package on the CPU."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SegmentationConfig as JConfig
from hiprfish_tpu.ops import line_profile as jlp
from hiprfish_tpu.ops import lp3d_pallas
from hiprfish_tpu.pipeline import segment3d as jseg3d
from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.kernels import gen_lpcv3d_tables
from hiprfish_tpu_torch.ops import line_profile as tlp

torch.set_num_threads(1)

HEADER = Path(tlp.__file__).parent.parent / "csrc" / "lpcv3d_tables.cuh"


def _volume(shape=(48, 40, 24), seed=0):
    """Smooth blobs plus noise: many distinct ratios per voxel, and values
    whose bf16 rounding changes the result."""
    rng = np.random.RandomState(seed)
    xx, yy, zz = np.mgrid[:shape[0], :shape[1], :shape[2]].astype(np.float32)
    return (0.5 + 0.3 * np.sin(xx / 5) * np.cos(yy / 4) * np.cos(zz / 3)
            + 0.05 * rng.rand(*shape)).astype(np.float32)


@pytest.mark.parametrize("patch,theta,phi", [(11, 9, 9), (7, 5, 4),
                                             (11, 4, 6)])
def test_line_table_3d_equal(patch, theta, phi):
    np.testing.assert_array_equal(tlp.line_table_3d(patch, theta, phi),
                                  jlp.line_table_3d(patch, theta, phi))


def test_header_line_table_equal():
    text = HEADER.read_text()
    body = text[text.index("#define HF_LP3D_LINES(L, S)"):
                text.index("#define HF_LP3D_SELECT(CX)")]
    assert [int(t) for t in re.findall(r"L\((\d+),", body)] == \
        list(range(72))
    table = np.array(re.findall(r"S\((-?\d+), (-?\d+), (-?\d+)\)", body),
                     dtype=np.int64)
    np.testing.assert_array_equal(table.reshape(72, 11, 3),
                                  jlp.line_table_3d(11, 9, 9))


def test_header_selection_network_equal():
    text = HEADER.read_text()
    macro = text[text.index("#define HF_LP3D_SELECT(CX)"):]
    pairs = [(int(a), int(b))
             for a, b in re.findall(r"CX\((\d+), (\d+)\)", macro)]
    (lo25, hi25, _), (lo75, hi75, _) = lp3d_pallas._quartile_ranks(72)
    assert (lo25, hi25, lo75, hi75) == (17, 18, 53, 54)
    ranks = {k: int(re.search(rf"#define HF_LP3D_{k} (\d+)", text).group(1))
             for k in ("LO25", "HI25", "LO75", "HI75")}
    assert ranks == {"LO25": 17, "HI25": 18, "LO75": 53, "HI75": 54}
    assert pairs == list(lp3d_pallas.selection_network(
        72, (lo25, hi25, lo75, hi75)))


def test_header_is_the_generator_output():
    assert HEADER.read_text() == gen_lpcv3d_tables.header_text()


@pytest.mark.parametrize("patch,theta,phi", [(7, 5, 6), (5, 3, 4)])
def test_generated_header_of_other_configurations(patch, theta, phi):
    # the header the build writes for a non-default configuration holds
    # the reference's line table, quartile ranks and selection network
    text = gen_lpcv3d_tables.header_text(patch, theta, phi)
    n_orient = (theta - 1) * phi
    defs = {k: int(re.search(rf"#define HF_LP3D_{k} (\d+)", text).group(1))
            for k in ("NORIENT", "PATCH", "THETA", "PHI", "LO25", "HI25",
                      "LO75", "HI75")}
    (lo25, hi25, _), (lo75, hi75, _) = lp3d_pallas._quartile_ranks(n_orient)
    assert defs == {"NORIENT": n_orient, "PATCH": patch, "THETA": theta,
                    "PHI": phi, "LO25": lo25, "HI25": hi25, "LO75": lo75,
                    "HI75": hi75}
    body = text[text.index("#define HF_LP3D_LINES(L, S)"):
                text.index("#define HF_LP3D_SELECT(CX)")]
    table = np.array(re.findall(r"S\((-?\d+), (-?\d+), (-?\d+)\)", body),
                     dtype=np.int64)
    np.testing.assert_array_equal(table.reshape(n_orient, patch, 3),
                                  jlp.line_table_3d(patch, theta, phi))
    macro = text[text.index("#define HF_LP3D_SELECT(CX)"):]
    pairs = [(int(a), int(b))
             for a, b in re.findall(r"CX\((\d+), (\d+)\)", macro)]
    assert pairs == list(lp3d_pallas.selection_network(
        n_orient, (lo25, hi25, lo75, hi75)))
    each = re.search(r"#define HF_LP3D_EACH\(M, (.*?)\) (.*)", text)
    assert len(each.group(1).split(", ")) == patch - 1
    assert each.group(2).count("M(") == patch - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selection_network_gives_exact_order_statistics(seed):
    # the committed network applied to random rows (with ties) leaves the
    # four ranks the kernel reads equal to a full sort's
    rng = np.random.RandomState(seed)
    vals = np.round(rng.rand(500, 72) * 20) / 20
    text = HEADER.read_text()
    macro = text[text.index("#define HF_LP3D_SELECT(CX)"):]
    r = vals.copy()
    for a, b in re.findall(r"CX\((\d+), (\d+)\)", macro):
        a, b = int(a), int(b)
        lo, hi = np.minimum(r[:, a], r[:, b]), np.maximum(r[:, a], r[:, b])
        r[:, a], r[:, b] = lo, hi
    s = np.sort(vals, axis=1)
    for k in (17, 18, 53, 54):
        np.testing.assert_array_equal(r[:, k], s[:, k])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["xyz", "xzy"])
def test_lp_cv_enhance_3d_plain_matches_jax(bf16, layout):
    vol = _volume()
    if layout == "xzy":
        vol = np.ascontiguousarray(vol.transpose(0, 2, 1))
    ref = np.asarray(jseg3d.lp_cv_enhance_3d_chunked(
        jnp.asarray(vol), JConfig(), 16, bf16, layout))
    out = tlp.lp_cv_enhance_3d(torch.from_numpy(vol), 11, 9, 9, 16, bf16,
                               layout)
    assert out.shape == vol.shape and out.dtype == torch.float32
    # f32 summation order of the 72-orientation mean: a few ulps
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_lp_cv_enhance_3d_plain_matches_jax_other_configuration(bf16):
    # (7, 5, 6): 24 orientations of 7 samples, interpolated quartiles
    vol = np.ascontiguousarray(_volume((20, 18, 12), 4).transpose(0, 2, 1))
    cfg = JConfig(patch_size=7, theta_range=5, phi_range=6)
    ref = np.asarray(jseg3d.lp_cv_enhance_3d_chunked(
        jnp.asarray(vol), cfg, 16, bf16, "xzy"))
    out = tlp.lp_cv_enhance_3d(torch.from_numpy(vol), 7, 5, 6, 16, bf16,
                               "xzy")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


# configurations whose plane ring does not fit a 32-wide block: kernel B6
# marches 16-wide blocks there (and past those, reads global memory)
@pytest.mark.parametrize("patch,theta,phi,bf16", [(21, 5, 4, False),
                                                  (29, 3, 4, True)])
def test_lp_cv_enhance_3d_plain_matches_jax_large_patch(patch, theta, phi,
                                                        bf16):
    vol = np.ascontiguousarray(_volume((14, 16, 10), 6).transpose(0, 2, 1))
    cfg = JConfig(patch_size=patch, theta_range=theta, phi_range=phi)
    ref = np.asarray(jseg3d.lp_cv_enhance_3d_chunked(
        jnp.asarray(vol), cfg, 16, bf16, "xzy"))
    out = tlp.lp_cv_enhance_3d(torch.from_numpy(vol), patch, theta, phi, 16,
                               bf16, "xzy")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_bf16_mode_rounds_the_samples():
    vol = _volume(seed=1)
    t = torch.from_numpy(vol)
    f32 = tlp.lp_cv_enhance_3d(t, bf16=False)
    bf = tlp.lp_cv_enhance_3d(t, bf16=True)
    ref = tlp.lp_cv_enhance_3d(t.to(torch.bfloat16).to(torch.float32),
                               bf16=False)
    assert float((f32 - bf).abs().max()) > 1e-3
    torch.testing.assert_close(bf, ref, rtol=0, atol=0)
    # None is f32 on a CPU tensor, as the reference's CPU backend
    torch.testing.assert_close(tlp.lp_cv_enhance_3d(t), f32, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_chunking_does_not_change_the_result(chunk):
    vol = torch.from_numpy(_volume((20, 18, 12), 2))
    full = tlp.lp_cv_enhance_3d_plain(vol, chunk_xy=64)
    torch.testing.assert_close(
        tlp.lp_cv_enhance_3d_plain(vol, chunk_xy=chunk), full, rtol=0,
        atol=0)


def test_wrapper_takes_plain_on_cpu_and_refuses_bad_args():
    vol = torch.from_numpy(_volume((12, 10, 8)))
    before = kernels.launch_counts()
    tlp.lp_cv_enhance_3d(vol)
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="layout"):
        tlp.lp_cv_enhance_3d(vol, layout="zyx")
    with pytest.raises(ValueError, match="unsupported device"):
        tlp.lp_cv_enhance_3d(vol.to("meta"))
