"""The CUDA kernels' bindings, build and dispatch, and the port on the card.

Tests marked ``cuda`` hold each kernel against its plain-torch twin on the
card, and the CUDA KMeans against the CPU one; they need an NVIDIA GPU
with nvcc and skip without one. This file imports no jax, so it runs on a
machine without it. On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda

The unmarked tests run anywhere: a wrapper takes its plain version only
for a CPU tensor, refuses other devices, and the bindings refuse non-CUDA
tensors before anything is built.
"""

import os

import numpy as np
import pytest
import torch

from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.config import TEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.kernels import _build
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.ops import denoise, kmeans, line_profile, segstats
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.pipeline import fused, fused_ecoli, segment2d
from hiprfish_tpu_torch.pipeline import segment3d
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _smooth(shape, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]].astype(np.float32)
    return (0.5 + 0.3 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            + 0.005 * rng.randn(*shape)).astype(np.float32)


def _bimodal(shape, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.gamma(2.0, 0.05, shape).astype(np.float32)
    n = shape[0] * shape[1] // 20
    img[rng.randint(0, shape[0], n), rng.randint(0, shape[1], n)] += \
        rng.normal(0.8, 0.1, n).astype(np.float32)
    return img


def _labels(shape, seed=0):
    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int32)
    for i in range(1, 40):
        r, c = rng.randint(0, shape[0] - 6), rng.randint(0, shape[1] - 9)
        lab[r:r + 6, c:c + 9] = i
    return lab


# -- anywhere ---------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda t: kernels.nlm(t, 0.02, 7, 11),
    lambda t: kernels.lpcv2d(t, 11, 9),
    lambda t: kernels.label_stats(t.reshape(-1).to(torch.int32), None, None,
                                  None, 8, 0, False, *t.shape),
    lambda t: kernels.label_lookup(t.to(torch.int32), torch.ones(8)),
    lambda t: kernels.stats_cm(t.reshape(-1).to(torch.int32),
                               t.reshape(1, -1), 8),
    lambda t: kernels.lpcv3d(t[None], True),
    lambda t: kernels.flood_min(t.to(torch.int32), t > 0, 2),
    lambda t: kernels.flood_reach(t > 0, t > 0, 1),
])
def test_bindings_refuse_cpu_tensors(call):
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros((16, 16)))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("call", [
    lambda t: denoise.denoise_nl_means(t),
    lambda t: line_profile.lp_cv_enhance_2d(t),
    lambda t: segstats.label_stats(t.to(torch.int32), None, 8),
    lambda t: segstats.label_lookup(t.to(torch.int32), torch.ones(8)),
    lambda t: segstats.stats_cm(t.to(torch.int32), t[None], 8),
    lambda t: line_profile.lp_cv_enhance_3d(t[None]),
])
def test_wrappers_refuse_other_devices(call):
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.zeros((16, 16), device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_build_dir_hashes_sources_and_flags(monkeypatch):
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and d == _build.build_dir()
    assert {p.name for p in _build.sources()} >= {
        "nlm.cu", "lpcv2d.cu", "segstats.cu", "lpcv3d.cu", "flood.cu",
        "lpcv3d_tables.cuh"}
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.build_dir() != d


def test_reset_launches():
    kernels.nlm.launches = 3
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
# narrower or shorter than the 64 x 64 tile and than 2 * pd + 7 (24 x 30,
# 37 x 200), and sizes that are not multiples of the tile; pd + patch / 2
# above 16 takes the 32 x 32 tile geometry, up to its limit of 72
@pytest.mark.parametrize("shape,patch,pd", [
    ((96, 160), 7, 11), ((70, 53), 7, 11), ((300, 257), 7, 11),
    ((24, 30), 7, 11), ((37, 200), 7, 11), ((130, 203), 7, 11),
    ((96, 160), 7, 15), ((24, 30), 7, 20), ((130, 203), 9, 40),
    ((150, 171), 7, 69),
    # past pd + patch / 2 = 72 the window is read from global memory
    ((96, 160), 7, 80), ((90, 83), 15, 66)])
def test_nlm_kernel_matches_plain(cuda, shape, patch, pd):
    img = torch.from_numpy(_smooth(shape)).to(cuda)
    out = kernels.nlm(img, 0.02, patch, pd)
    ref = denoise.denoise_nl_means_plain(img, 0.02, patch, pd)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
# (11, 9) the main path's stencil (its own kernel), (7, 5) a smaller one
# and (15, 12) a larger one with interpolated quartiles (both the kernel
# for any stencil)
@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5), (15, 12)])
@pytest.mark.parametrize("shape", [(96, 160), (33, 41)])
def test_lpcv2d_kernel_matches_plain(cuda, shape, patch, phi):
    img = torch.from_numpy(_smooth(shape, 1)).to(cuda)
    before = kernels.lpcv2d.launches
    out = line_profile.lp_cv_enhance_2d(img, patch, phi)
    assert kernels.lpcv2d.launches == before + 1
    ref = line_profile.lp_cv_enhance_2d_plain(img, patch, phi)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
# past the former caps: patch 131 (halo 65) and phi 129 and 240 (ratios
# past any fixed per-thread array); interpolated quartiles throughout
@pytest.mark.parametrize("patch,phi", [(131, 5), (11, 129), (11, 240)])
@pytest.mark.parametrize("shape", [(40, 56), (33, 41)])
def test_lpcv2d_kernel_large_stencils(cuda, shape, patch, phi):
    img = torch.from_numpy(_smooth(shape, 2)).to(cuda)
    before = kernels.lpcv2d.launches
    out = line_profile.lp_cv_enhance_2d(img, patch, phi)
    assert kernels.lpcv2d.launches == before + 1
    ref = line_profile.lp_cv_enhance_2d_plain(img, patch, phi)
    # the phi-term mean summed in another order: up to phi ulps of 1
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=max(1e-6, phi * 2.0 ** -24))


@pytest.mark.cuda
@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5)])
@pytest.mark.parametrize("scale", [1e-20, 1e30])
def test_lpcv2d_kernel_exact_slow_path(cuda, patch, phi, scale):
    # differences below 2^-60 or ranges above 2^60: the (11, 9) kernel's
    # written-out quotient is not certain to be exact there, and the
    # block's pixels are redone with the compiler's division (which the
    # kernel for any other stencil always takes); the result is scale-free
    img = torch.from_numpy(_smooth((70, 53), 3) * np.float32(scale)) \
        .to(cuda)
    out = line_profile.lp_cv_enhance_2d(img, patch, phi)
    ref = line_profile.lp_cv_enhance_2d_plain(img, patch, phi)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_label_stats_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(2)
    lab = torch.from_numpy(_labels((64, 96))).to(cuda)
    img = torch.from_numpy(rng.rand(64, 96, 7).astype(np.float32)) \
        .to(cuda).to(dtype)
    aux = torch.from_numpy(rng.randint(-1, 5, (64, 96)).astype(np.int32)) \
        .to(cuda)
    mask = torch.from_numpy((rng.rand(64, 96) > 0.4).astype(np.float32)) \
        .to(cuda)
    args = (lab.reshape(-1), img.reshape(-1, 7), aux.reshape(-1),
            mask.reshape(-1), 48, 4, True, 64, 96)
    out = kernels.label_stats(*args)
    ref = segstats.label_stats_table_plain(*args)
    # count, border, moments, aux histogram and 0/1 mask count: bitwise
    exact = list(range(7)) + list(range(14, 19))
    assert torch.equal(out[:, exact], ref[:, exact])
    torch.testing.assert_close(out, ref, rtol=2.0 ** -16, atol=1e-4)


def _b3_args(cuda, kind, shape=(192, 256), seed=6):
    """B3's column sets on the main paths: counts only, counts + a
    41-class aux histogram, and the 10-bit set (95 bf16 channels, moments,
    aux, 0/1 mask); the labels are cells of a few px to ~30 px per row."""
    rng = np.random.RandomState(seed)
    h, w = shape
    lab = np.zeros(shape, np.int32)
    for i in range(1, 120):
        r, c = rng.randint(0, h - 4), rng.randint(0, w - 4)
        lab[r:r + rng.randint(2, 20), c:c + rng.randint(2, 40)] = i
    lab[0, :3] = [5, 500, -2]                  # clipped and negative ids
    flat = torch.from_numpy(lab).to(cuda).reshape(-1)
    aux = torch.from_numpy(rng.randint(-1, 42, h * w).astype(np.int32)) \
        .to(cuda)
    if kind == "counts":
        return (flat, None, None, None, 256, 0, False, h, w)
    if kind == "aux":
        return (flat, None, aux, None, 256, 41, False, h, w)
    img = torch.from_numpy(rng.rand(h * w, 95).astype(np.float32)).to(cuda) \
        .to(torch.bfloat16)
    mask = torch.from_numpy((rng.rand(h * w) > 0.3).astype(np.float32)) \
        .to(cuda)
    return (flat, img, aux, mask, 256, 41, True, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["counts", "aux", "10bit"])
def test_label_stats_integer_columns_bitwise_and_repeatable(cuda, kind):
    args = _b3_args(cuda, kind)
    out = kernels.label_stats(*args)
    again = kernels.label_stats(*args)
    ref = segstats.label_stats_table_plain(*args)
    nchan = 0 if args[1] is None else args[1].shape[1]
    nmom = 5 if args[6] else 0
    exact = [c for c in range(out.shape[1])
             if not 2 + nmom <= c < 2 + nmom + nchan]
    assert torch.equal(out[:, exact], ref[:, exact])
    assert torch.equal(out[:, exact], again[:, exact])
    torch.testing.assert_close(out, ref, rtol=2.0 ** -16, atol=1e-4)


@pytest.mark.cuda
def test_label_lookup_kernel_matches_plain(cuda):
    lab = torch.from_numpy(_labels((64, 96), 3)).to(cuda)
    lab[0, :5] = torch.tensor([-3, 0, 100, 47, 48], device=cuda)
    table = torch.rand(48, device=cuda) + 1.0
    out = kernels.label_lookup(lab, table)
    torch.testing.assert_close(out, segstats.label_lookup_plain(lab, table),
                               rtol=0, atol=0)


@pytest.mark.cuda
# n % 4 != 0 (the scalar tail), and contiguous views whose storage offset
# leaves the labels off 16-byte alignment (the scalar head; the output is
# then stored pixel by pixel)
@pytest.mark.parametrize("n,offset", [(4001, 0), (7, 0), (3, 0), (4000, 1),
                                      (4003, 2), (4097, 3)])
def test_label_lookup_kernel_ragged_and_misaligned(cuda, n, offset):
    rng = np.random.RandomState(n + offset)
    base = torch.from_numpy(rng.randint(-2, 60, n + offset)
                            .astype(np.int32)).to(cuda)
    lab = base[offset:]
    assert lab.is_contiguous() and lab.storage_offset() == offset
    table = torch.rand(48, device=cuda) + 1.0
    before = kernels.label_lookup.launches
    out = segstats.label_lookup(lab, table)
    assert kernels.label_lookup.launches == before + 1
    torch.testing.assert_close(out, segstats.label_lookup_plain(lab, table),
                               rtol=0, atol=0)


@pytest.mark.cuda
# the int32 store on the vector path, the scalar tail and a misaligned head
@pytest.mark.parametrize("n,offset", [(64 * 96, 0), (4001, 0), (4003, 2)])
def test_label_lookup_int32_kernel_matches_plain(cuda, n, offset):
    rng = np.random.RandomState(n + offset)
    base = torch.from_numpy(rng.randint(-2, 60, n + offset)
                            .astype(np.int32)).to(cuda)
    lab = base[offset:]
    # a remap table (integers) and a float table (truncated toward zero)
    for table in (torch.arange(48, device=cuda, dtype=torch.float32) * 3,
                  torch.rand(48, device=cuda) * 40 - 20):
        before = kernels.label_lookup.launches
        out = segstats.label_lookup(lab, table, out_dtype=torch.int32)
        assert kernels.label_lookup.launches == before + 1
        assert out.dtype == torch.int32
        assert torch.equal(out, segstats.label_lookup_plain(
            lab, table, torch.int32))
        assert torch.equal(out, kernels.label_lookup(lab, table)
                           .to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.float16, torch.bool])
def test_label_lookup_kernel_refuses_other_out_dtypes(cuda, dtype):
    lab = torch.zeros(16, dtype=torch.int32, device=cuda)
    before = kernels.launch_counts()
    with pytest.raises(TypeError, match="out_dtype"):
        segstats.label_lookup(lab, torch.ones(8, device=cuda),
                              out_dtype=dtype)
    assert kernels.launch_counts() == before


@pytest.mark.cuda
def test_brightest_cluster_mask_cuda_vs_cpu(cuda):
    img = torch.from_numpy(_bimodal((768, 768)))
    c_cpu = kmeans.kmeans1d_centers(img, 2, 40)
    c_gpu = kmeans.kmeans1d_centers(img.to(cuda), 2, 40).cpu()
    # the card sums the bins in fixed point and rounds once, the CPU in
    # sequential f32: the centres agree to a few ulps, not bitwise
    torch.testing.assert_close(c_gpu, c_cpu, rtol=1e-6, atol=0)
    m_cpu = kmeans.brightest_cluster_mask(img, 2, 40)
    m_gpu = kmeans.brightest_cluster_mask(img.to(cuda), 2, 40).cpu()
    differ = m_cpu != m_gpu
    if differ.any():
        # only pixels within that rounding of the threshold change side
        thr = (c_cpu[-1] + c_cpu[-2]) / 2
        assert float((img[differ] - thr).abs().max()) <= 1e-6 * float(thr)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(768, 768), (256, 256)])
def test_kmeans_centres_bitwise_equal_across_calls(cuda, shape):
    # the fixed-point bin sums are order-free: two calls on the same image
    # give the same centres, threshold and mask bit for bit
    img = torch.from_numpy(_bimodal(shape, 4)).to(cuda)
    first = kmeans.kmeans1d_centers_multi(img, (2, 3), 40)
    again = kmeans.kmeans1d_centers_multi(img, (2, 3), 40)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.equal(kmeans.brightest_cluster_mask(img),
                       kmeans.brightest_cluster_mask(img))


def _volume(shape, seed=0):
    rng = np.random.RandomState(seed)
    xx, yy, zz = np.mgrid[:shape[0], :shape[1], :shape[2]].astype(np.float32)
    return (0.5 + 0.3 * np.sin(xx / 5) * np.cos(yy / 4) * np.cos(zz / 3)
            + 0.05 * rng.rand(*shape)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("shape", [(40, 24, 70), (17, 9, 33), (7, 13, 45),
                                   (19, 5, 100)])
def test_lpcv3d_kernel_matches_plain(cuda, bf16, shape):
    # (X, Z, Y): ragged against the block's 16 x-planes, 8 z and 32 y on
    # every axis; odd nz (the last voxel pair has one voxel), nx < 11 (the
    # plane ring clamps), ny not a multiple of 32
    vol = torch.from_numpy(_volume(shape, 1)).to(cuda)
    out = line_profile.lp_cv_enhance_3d(vol, bf16=bf16, layout="xzy")
    ref = line_profile.lp_cv_enhance_3d_plain(vol, bf16=bf16, layout="xzy")
    # f32 summation order of the 72-orientation mean
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("shape", [(20, 12, 40), (9, 7, 33)])
def test_lpcv3d_kernel_other_configuration(cuda, bf16, shape):
    # (7, 5, 6): 24 orientations of 7 samples, compiled at first use from
    # its own generated header
    vol = torch.from_numpy(_volume(shape, 5)).to(cuda)
    before = kernels.lpcv3d.launches
    out = line_profile.lp_cv_enhance_3d(vol, 7, 5, 6, bf16=bf16,
                                        layout="xzy")
    assert kernels.lpcv3d.launches == before + 1
    ref = line_profile.lp_cv_enhance_3d_plain(vol, 7, 5, 6, bf16=bf16,
                                              layout="xzy")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
# rings that do not fit a 32-wide block: 16-wide blocks at (21, 5, 4) f32
# and (29, 3, 4) bf16; past those, the global-memory kernel at (25, 3, 2)
# f32 and (33, 3, 2) bf16
@pytest.mark.parametrize("cfg,bf16", [((21, 5, 4), False),
                                      ((29, 3, 4), True),
                                      ((25, 3, 2), False),
                                      ((33, 3, 2), True)])
@pytest.mark.parametrize("shape", [(20, 12, 40), (9, 7, 33)])
def test_lpcv3d_kernel_large_patch(cuda, cfg, bf16, shape):
    vol = torch.from_numpy(_volume(shape, 6)).to(cuda)
    before = kernels.lpcv3d.launches
    out = line_profile.lp_cv_enhance_3d(vol, *cfg, bf16=bf16, layout="xzy")
    assert kernels.lpcv3d.launches == before + 1
    ref = line_profile.lp_cv_enhance_3d_plain(vol, *cfg, bf16=bf16,
                                              layout="xzy")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("scale", [1e-20, 1e30])
def test_lpcv3d_kernel_exact_slow_path(cuda, bf16, scale):
    # differences below 2^-60 or ranges above 2^60: the kernel's written-out
    # quotient is not certain to be exact there, and the pair is redone with
    # the compiler's division; the result is scale-free
    vol = torch.from_numpy(_volume((19, 11, 40), 3) * np.float32(scale)) \
        .to(cuda)
    out = line_profile.lp_cv_enhance_3d(vol, bf16=bf16, layout="xzy")
    ref = line_profile.lp_cv_enhance_3d_plain(vol, bf16=bf16, layout="xzy")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_lpcv3d_kernel_xyz_layout(cuda):
    vol = torch.from_numpy(_volume((20, 26, 12), 2)).to(cuda)
    out = line_profile.lp_cv_enhance_3d(vol, layout="xyz")
    ref = line_profile.lp_cv_enhance_3d_plain(vol, bf16=True, layout="xyz")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def _edge_pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(t[None, None], (pad,) * (2 * t.ndim),
                                   mode="replicate")[0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
def test_lpcv3d_kernel_matches_stencil_form(cuda, bf16):
    # a second reference: the combine of line_profile_3d's normalised
    # centres on the edge-padded (x, y, z) volume, min and max in bf16 in
    # the bf16 mode, as the kernel's samples
    vol = torch.from_numpy(_volume((24, 17, 40), 7)).to(cuda)   # (X, Z, Y)
    out = line_profile.lp_cv_enhance_3d(vol, bf16=bf16, layout="xzy")
    pad = _edge_pad(vol.permute(0, 2, 1), 5)
    if bf16:
        pad = pad.to(torch.bfloat16)
    ref = line_profile._lp_cv_combine(line_profile.line_profile_3d(pad))
    torch.testing.assert_close(out, ref.permute(0, 2, 1), rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("patch,phi", [(11, 9), (7, 5)])
def test_lpcv2d_kernel_matches_stencil_form(cuda, patch, phi):
    # a second reference: the quartile combine of line_profile_2d's
    # min-max normalised centres
    img = torch.from_numpy(_smooth((96, 160), 8)).to(cuda)
    out = line_profile.lp_cv_enhance_2d(img, patch, phi)
    prof = line_profile.line_profile_2d(_edge_pad(img, (patch - 1) // 2),
                                        patch, phi)
    lo, hi = prof.min(dim=-1).values, prof.max(dim=-1).values
    rnc = (prof[..., (patch - 1) // 2] - lo) / torch.clamp(hi - lo, min=1e-8)
    torch.testing.assert_close(out, line_profile._lp_cv_combine(rnc),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_cm_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(4)
    lab = torch.from_numpy(np.stack([_labels((64, 96), s) for s in (0, 1)]))
    lab[0, 0, :4] = torch.tensor([-1, 60, 47, 48])
    lab = lab.to(cuda)
    img = torch.from_numpy(rng.rand(9, 2, 64, 96).astype(np.float32)) \
        .to(cuda).to(dtype)
    out = kernels.stats_cm(lab.reshape(-1).to(torch.int32),
                           img.reshape(9, -1), 48)
    ref = segstats.stats_cm_plain(lab.reshape(-1), img.reshape(9, -1), 48)
    torch.testing.assert_close(out[:, 0], ref[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(out, ref, rtol=2.0 ** -16, atol=1e-5)


def _b5_case(kind, nchan, dtype, cuda, nseg=48):
    """(labels (n,), image (C, n)) of a B5 case: runs of random length and
    id (a third background) over n pixels; ``kind`` picks the shape of the
    case."""
    rng = np.random.RandomState(len(kind) * 7 + nchan)
    n = {"ragged": 6173, "offset": 6000}.get(kind, 8296)
    lab = np.zeros(n, np.int32)
    p = 0
    while p < n:
        k = rng.randint(1, 40)
        lab[p:p + k] = 0 if rng.rand() < 0.33 else rng.randint(1, nseg)
        p += k
    if kind == "background":
        lab[:] = 0
    elif kind == "one_id":
        lab[:] = 7
    elif kind == "edge_ids":
        # the last row, and ids past the table and below 1: nothing added
        for i, v in enumerate((nseg - 1, nseg, nseg + 5, -1, 0)):
            lab[i * 997:i * 997 + 300] = v
    img = rng.rand(nchan, n).astype(np.float32)
    if kind == "offset":
        # contiguous views whose storage offsets leave the labels and every
        # channel row off 16-byte alignment
        lab_t = torch.from_numpy(np.concatenate(
            [np.int32([3]), lab])).to(cuda)[1:]
        flat = torch.from_numpy(np.concatenate(
            [np.float32([0.5]), img.reshape(-1)]))
        img_t = flat.to(cuda).to(dtype)[1:].view(nchan, n)
        assert lab_t.storage_offset() == 1 and img_t.storage_offset() == 1
        return lab_t, img_t
    return (torch.from_numpy(lab).to(cuda),
            torch.from_numpy(img).to(cuda).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchan", [1, 63])
# n % 8 != 0 (the element-wise loads); views off 16-byte alignment; all
# background; one id over everything (runs across every lane and step);
# ids at num_segments - 1 and past it
@pytest.mark.parametrize("kind", ["cells", "ragged", "offset", "background",
                                  "one_id", "edge_ids"])
def test_stats_cm_kernel_cases(cuda, kind, nchan, dtype):
    lab, img = _b5_case(kind, nchan, dtype, cuda)
    assert lab.is_contiguous() and img.is_contiguous()
    before = kernels.stats_cm.launches
    out = kernels.stats_cm(lab, img, 48)
    assert kernels.stats_cm.launches == before + 1
    ref = segstats.stats_cm_plain(lab, img, 48)
    assert torch.equal(out[:, 0], ref[:, 0])  # counts bitwise
    torch.testing.assert_close(out, ref, rtol=2.0 ** -16, atol=1e-5)
    if kind == "background":
        assert not bool(out.any())


@pytest.mark.cuda
def test_stats_cm_kernel_adds_into_out(cuda):
    lab, img = _b5_case("cells", 9, torch.bfloat16, cuda)
    acc = torch.full((48, 10), 2.0, device=cuda)
    got = segstats.stats_cm(lab, img, 48, out=acc)
    assert got is acc
    ref = segstats.stats_cm_plain(lab, img, 48) + 2.0
    assert torch.equal(acc[:, 0], ref[:, 0])
    torch.testing.assert_close(acc, ref, rtol=2.0 ** -16, atol=1e-5)


@pytest.mark.cuda
def test_segment_3d_tiled_cuda_vs_cpu(cuda):
    # a small volume: plain versions on the CPU, kernels B3, B4, B6 on the
    # card, both in the card's bf16 LP-CV mode
    rng = np.random.RandomState(0)
    vol = rng.rand(96, 64, 32).astype(np.float32) * 0.05
    xx, yy, zz = np.mgrid[:96, :64, :32]
    for cx in (16, 48, 80):
        for cy in (16, 48):
            r2 = ((xx - cx) / 7.0) ** 2 + ((yy - cy) / 5.0) ** 2 \
                + ((zz - 16) / 6.0) ** 2
            vol += np.where(r2 <= 1, 1.0 - 0.2 * np.sqrt(r2), 0.0) \
                .astype(np.float32)
    kw = dict(max_cells=64, tile_x=32, margin=24, tile_cap=64, bf16=True)
    cpu, n_c, _ = segment3d.segment_3d_tiled(torch.from_numpy(vol), **kw)
    kernels.reset_launches()
    gpu, n_g, _ = segment3d.segment_3d_tiled(torch.from_numpy(vol).to(cuda),
                                             **kw)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("label_stats", "label_lookup",
                                       "lpcv3d"))
    assert n_c == n_g >= 6
    assert float((cpu == gpu.cpu()).float().mean()) >= 0.9999


def _ecoli_fov_192():
    """The 192^2 10-bit FOV of the JAX package's fused-vs-host test."""
    return synthetic.make_fov(
        TEN_BIT, [5, 37, 515, 1023, 96, 640, 17, 260, 770], shape=(192, 192),
        seed=1, laser_shifts=[(0, 0), (1, -1), (0, 1), (-1, 0), (1, 1)],
        cell_axes=(9.0, 14.0))


@pytest.mark.cuda
def test_label_stats_kernel_ecoli_columns(cuda):
    # the 10-bit step's measurement pass: 95 bf16 channels, moments, a
    # 41-class aux histogram and a mask, on planted cells at 192^2
    fov = _ecoli_fov_192()
    rng = np.random.RandomState(5)
    lab = torch.from_numpy(fov["truth_labels"]).to(cuda).reshape(-1)
    img = torch.from_numpy(np.concatenate(fov["stack"], axis=2)).to(cuda) \
        .to(torch.bfloat16).reshape(lab.shape[0], 95)
    aux = torch.from_numpy(rng.randint(0, 41, lab.shape[0])
                           .astype(np.int32)).to(cuda)
    mask = torch.from_numpy((rng.rand(lab.shape[0]) > 0.3)
                            .astype(np.float32)).to(cuda)
    args = (lab, img, aux, mask, 64, 41, True, 192, 192)
    out = kernels.label_stats(*args)
    ref = segstats.label_stats_table_plain(*args)
    # count, border, moments (int64 sums rounded once), aux histogram and
    # mask count: bitwise
    exact = list(range(7)) + list(range(7 + 95, 7 + 95 + 41 + 1))
    torch.testing.assert_close(out[:, exact], ref[:, exact], rtol=0, atol=0)
    torch.testing.assert_close(out[:, 7:7 + 95], ref[:, 7:7 + 95],
                               rtol=2.0 ** -16, atol=1e-4)


@pytest.mark.cuda
def test_fov_step_ecoli_cuda_vs_cpu(cuda):
    # the 10-bit step: plain versions on the CPU, kernels B3, B4 on the card
    fov = _ecoli_fov_192()
    clf = load_classifier(os.path.join(os.path.dirname(__file__), "fixtures",
                                       "torch_port_clf_10b_1023x200.npz"))
    outs = []
    kernels.reset_launches()
    for d in (torch.device("cpu"), cuda):
        arrays, static = fused.classifier_from_numpy(clf, d)
        stack = tuple(torch.from_numpy(a).to(d) for a in fov["stack"])
        outs.append(fused_ecoli.fov_step_ecoli(stack, arrays,
                                               SegmentationConfig(), 64,
                                               static))
    counts = kernels.launch_counts()
    assert counts["label_stats"] >= 3 and counts["label_lookup"] >= 3
    cpu, gpu = outs
    assert int(cpu.n_cells) == int(gpu.n_cells) == 9
    agree = float((cpu.segmentation == gpu.segmentation.cpu()).float().mean())
    assert agree >= 0.999
    v = cpu.valid
    assert torch.equal(cpu.code_idx[v], gpu.code_idx.cpu()[v])


@pytest.mark.cuda
def test_segment_ecoli_cuda_vs_cpu(cuda):
    fov = _ecoli_fov_192()
    cpu = segment2d.segment_ecoli(
        [torch.from_numpy(a) for a in fov["stack"]], SegmentationConfig(), 64)
    gpu = segment2d.segment_ecoli(
        [torch.from_numpy(a).to(cuda) for a in fov["stack"]],
        SegmentationConfig(), 64)
    assert int(cpu.n_cells) == int(gpu.n_cells) == 9
    agree = float((cpu.segmentation == gpu.segmentation.cpu()).float().mean())
    assert agree >= 0.999


@pytest.mark.cuda
def test_prefetcher_stages_planes_on_the_card(tmp_path, cuda):
    """io/loader.FovPrefetcher with a CUDA device: pinned buffers copied on
    a side stream, read at once on the consumer's stream, equal bitwise to
    plain copies of the planes read on the host (.npy, Gray32Float and
    Gray16 JPEG-XR .czi)."""
    from hiprfish_tpu_torch.io import czi
    from hiprfish_tpu_torch.io import images as iio
    from hiprfish_tpu_torch.io.loader import FovPrefetcher

    rng = np.random.RandomState(0)
    fovs = []
    for i in range(4):
        files = [str(tmp_path / f"s{i}_{laser}.{ext}")
                 for laser, ext in (("488", "npy"), ("514", "czi"),
                                    ("561", "czi"))]
        np.save(files[0], rng.rand(256, 320, 3).astype(np.float32))
        czi.write_czi(files[1], rng.rand(256, 320, 5).astype(np.float32))
        czi.write_czi(files[2],
                      (rng.rand(256, 320, 2) * 65535).astype(np.uint16),
                      pixel_type=1, compression=czi.COMP_JPEGXR)
        fovs.append((f"s{i}", files))
    with FovPrefetcher(fovs, depth=3, device=cuda) as loader:
        for (key, stack), (want_key, files) in zip(loader, fovs):
            assert key == want_key
            doubled = [t * 2.0 for t in stack]
            for t, d, f in zip(stack, doubled, files):
                want = torch.from_numpy(iio.load_image(f)).to(cuda)
                assert t.device == cuda and t.dtype == torch.float32
                assert torch.equal(t, want) and torch.equal(d, want * 2.0)


def _flood_case(cuda, kind, shape, density, seed):
    """A random mask and state of one flood round on the card: the min
    state with values off the mask (round 1 of rank reads them) and runs
    of every length, the reach state sparse seeds."""
    gen = torch.Generator().manual_seed(seed)
    mask = torch.rand(shape, generator=gen) < density
    if kind == "min":
        cur = torch.randint(1, 1 << 20, shape, generator=gen,
                            dtype=torch.int32)
        cur[torch.rand(shape, generator=gen) < 0.2] = lab._INF
    else:
        cur = torch.rand(shape, generator=gen) < 0.02
    return cur.to(cuda), mask.to(cuda)


def _flood_pair(kind, cur, mask, connectivity, max_run):
    """(kernel round, plain round) of one flood round on the card."""
    if kind == "min":
        got = kernels.flood_min(cur, mask, connectivity, max_run)
        (want,) = lab._min_round_plain(cur.ndim, connectivity, max_run)(
            (cur,), (mask, torch.full_like(cur, lab._INF)))
    else:
        got = kernels.flood_reach(cur, mask, connectivity, max_run)
        (want,) = lab._reach_round_plain(cur.ndim, connectivity, max_run)(
            (cur,), (mask,))
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["min", "reach"])
@pytest.mark.parametrize("max_run", [None, 1, 2, 5, 16, 32, 64, 128])
@pytest.mark.parametrize("shape,connectivity", [
    ((1,), 1), ((2,), 1), ((3001,), 1), ((333, 517), 1), ((333, 517), 2),
    ((2000, 64), 2), ((64, 2000), 1), ((7, 170, 301), 1), ((7, 170, 301), 2),
    ((7, 170, 301), 3), ((40, 33, 65), 3), ((8, 170, 2020), 3),
    ((1, 1, 600), 3), ((600, 1, 1), 2)])
def test_flood_round_kernels_bitwise_plain(cuda, kind, max_run, shape,
                                           connectivity):
    """Each kernel round against its plain twin on the card, bitwise:
    1-3D, every connectivity, caps from none to past the line, masks
    sparse, half full and nearly solid, sizes up to a tile's slice of
    8 planes, and unit axes."""
    for density in (0.3, 0.6, 0.97):
        cur, mask = _flood_case(cuda, kind, shape, density,
                                sum(shape) + int(100 * density))
        before = getattr(kernels, f"flood_{kind}").launches
        got, want = _flood_pair(kind, cur, mask, connectivity, max_run)
        torch.cuda.synchronize()
        assert getattr(kernels, f"flood_{kind}").launches == before + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), (density, int((got != want).sum()))


@pytest.mark.cuda
def test_flood_round_kernels_refuse_other_inputs(cuda):
    cur = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    mask = torch.ones((8, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        kernels.flood_min(cur.to(torch.int64), mask, 2)
    with pytest.raises(TypeError, match="dtype"):
        kernels.flood_reach(cur, mask, 2)
    with pytest.raises(TypeError, match="dtype"):
        kernels.flood_min(cur, mask.to(torch.uint8), 2)
    with pytest.raises(ValueError, match="connectivity"):
        kernels.flood_min(cur, mask, 3)
    with pytest.raises(ValueError, match="connectivity"):
        kernels.flood_min(cur, mask, 1, 0)
    with pytest.raises(ValueError, match="shape"):
        kernels.flood_min(cur, mask[:4], 1)
    with pytest.raises(ValueError, match="shape"):
        kernels.flood_min(cur[None, None], mask[None, None], 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.flood_min(cur.t()[:, :4], mask[:, :4], 1)


@pytest.mark.cuda
def test_legacy_stacks_on_the_card(cuda):
    """The committed real-sklearn stacks (tools/make_torch_legacy_fixture.py)
    scored on the card, read without sklearn: the SVCs' predictions equal
    sklearn's stored ones, predict_proba within 5e-3 of sklearn's, the
    stacks' held-out calls all right, and the card's neighbours and calls
    equal to the CPU's."""
    from hiprfish_tpu_torch.models import umap_infer

    stacks = os.path.join(os.path.dirname(__file__), "fixtures",
                          "legacy_stacks")
    answers = np.load(os.path.join(stacks, "answers.npz"))
    for tag, name, load in (
            ("10b", "ref10_umap_transform.pkl",
             umap_infer.load_legacy_umap_stack),
            ("7b", "ref7_umap_transform_biofilm_7b.pkl",
             umap_infer.load_legacy_umap_stack_7b)):
        path = os.path.join(stacks, name)
        card, cpu = load(path, device=cuda), load(path, device="cpu")
        q = answers[f"queries_{tag}"]
        xs = card.check_inputs(torch.from_numpy(q).to(cuda))
        for i, (svc, (lo, hi)) in enumerate(zip(card.check_svcs,
                                                card.blocks)):
            np.testing.assert_array_equal(svc.predict(xs[:, lo:hi]),
                                          answers[f"check_pred_{tag}"][i])
        pts = answers[f"embed_points_{tag}"]
        np.testing.assert_array_equal(
            card.svc_embed.predict(pts).astype(str),
            answers[f"embed_pred_{tag}"])
        np.testing.assert_allclose(card.svc_embed.predict_proba(pts),
                                   answers[f"embed_proba_{tag}"], rtol=0,
                                   atol=5e-3)
        np.testing.assert_allclose(
            card.svc_embed.decision_function_ovo(pts).cpu().numpy(),
            cpu.svc_embed.decision_function_ovo(pts).numpy(), rtol=0,
            atol=1e-5)
        negs = torch.randint(0, card.umap.raw_data.shape[0],
                             (30, q.shape[0], 5),
                             generator=torch.Generator().manual_seed(0))
        calls = [s.predict(q, negatives=negs) for s in (card, cpu)]
        np.testing.assert_array_equal(calls[0], calls[1])
        np.testing.assert_array_equal(np.asarray(calls[0]).astype(str),
                                      answers[f"labels_{tag}"])
        feats = card.predict(q, negatives=negs, return_checks=True)[1]
        idx = [umap_infer.transform_full(s.umap, feats, s.distance_fn,
                                         negatives=negs, device=d)[1].cpu()
               for s, d in ((card, cuda), (cpu, "cpu"))]
        assert torch.equal(idx[0], idx[1])
