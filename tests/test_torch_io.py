"""Port parity for the host I/O (hiprfish_tpu_torch/io): the numpy CSV
writers give the JAX package's pandas writers' bytes, the PNGs decode to
the label2rgb / jet pixels, and the name parsers and the calibration cube
equal the reference's. Inputs that are not ported raise, and so do
missing or malformed .czi files (the reader's own errors)."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from hiprfish_tpu.io import images as jimages
from hiprfish_tpu.io import outputs as joutputs
from hiprfish_tpu.io import tables as jtables
from hiprfish_tpu_torch import cli
from hiprfish_tpu_torch.cli import biofilm as cli_biofilm
from hiprfish_tpu_torch.cli import classify as cli_classify
from hiprfish_tpu_torch.cli import classify_spectra as cli_classify_spectra
from hiprfish_tpu_torch.io import images, outputs, tables

torch.set_num_threads(1)


def decode_png(path):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG with filter 0 rows."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color, _, _, interlace = ihdr
    assert (depth, color, interlace) == (8, 2, 0)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def _rows(n, c, seed):
    """float32 rows with values near 0, 1e-7, 1 and 1e8."""
    rng = np.random.RandomState(seed)
    scale = np.array([1e-7, 1.0, 1e8, 0.0])[rng.randint(0, 4, (n, c))]
    return (rng.rand(n, c) * scale + rng.rand(n, c) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("n,c", [(1, 95), (7, 95), (1, 63), (12, 63)])
def test_csv_writers_equal_jax_bytes(tmp_path, n, c):
    arr = _rows(n, c, n * c)
    arr[0, :3] = (1 / 3, 2.5e-7, 123456.79)
    pairs = [
        (outputs.save_avgint_csv, joutputs.save_avgint_csv),
        (outputs.save_avgint_norm_csv_with_header,
         joutputs.save_avgint_norm_csv_with_header),
    ]
    for i, (mine, ref) in enumerate(pairs):
        mine(str(tmp_path / f"port{i}.csv"), arr)
        ref(str(tmp_path / f"jax{i}.csv"), arr)
        assert (tmp_path / f"port{i}.csv").read_bytes() \
            == (tmp_path / f"jax{i}.csv").read_bytes()
    codes = [format(int(v), "07b") for v in range(n)]
    outputs.save_cell_ids(str(tmp_path / "port_ids.txt"), codes)
    joutputs.save_cell_ids(str(tmp_path / "jax_ids.txt"), codes)
    assert (tmp_path / "port_ids.txt").read_bytes() \
        == (tmp_path / "jax_ids.txt").read_bytes()
    # the readers parse correctly rounded, as pandas' round_trip parser;
    # pandas' default parser can be one float64 ulp off on %.18e text,
    # which the float32 cast the classifiers make removes
    import pandas as pd

    got = outputs.read_spectra_csv(str(tmp_path / "port0.csv"))
    np.testing.assert_array_equal(
        got, pd.read_csv(tmp_path / "port0.csv", header=None,
                         float_precision="round_trip").values)
    np.testing.assert_array_equal(
        got.astype(np.float32),
        pd.read_csv(tmp_path / "port0.csv", header=None).values
        .astype(np.float32))
    np.testing.assert_array_equal(got.astype(np.float32), arr)
    back = outputs.read_spectra_csv(str(tmp_path / "port1.csv"), header=True)
    assert back.dtype == np.float64 and back.shape == (n, c)
    np.testing.assert_array_equal(back.astype(np.float32), arr)


def test_csv_reader_empty_files(tmp_path):
    (tmp_path / "empty.csv").write_text("")
    with pytest.raises(ValueError):
        outputs.read_spectra_csv(str(tmp_path / "empty.csv"))
    outputs.save_avgint_norm_csv_with_header(
        str(tmp_path / "h.csv"), np.zeros((0, 63), np.float32))
    assert outputs.read_spectra_csv(str(tmp_path / "h.csv"),
                                    header=True).shape == (0, 63)


def test_label2rgb_and_segmentation_png(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    seg = rng.randint(0, 40, (37, 53)).astype(np.int32)
    np.testing.assert_array_equal(outputs.label2rgb(seg),
                                  joutputs.label2rgb(seg))
    monkeypatch.chdir(tmp_path)
    outputs.save_segmentation(seg, "s")
    np.testing.assert_array_equal(np.load("s_seg.npy"), seg)
    np.testing.assert_array_equal(
        decode_png("s_seg.png"),
        np.round(255 * joutputs.label2rgb(seg)).astype(np.uint8))
    ident = rng.randint(0, 1024, (20, 30))
    outputs.save_identification_png(ident, "s")
    np.testing.assert_array_equal(
        decode_png("s_identification.png"),
        np.round(255 * joutputs.label2rgb(ident)).astype(np.uint8))


def test_sum_png_is_jet(tmp_path, monkeypatch):
    rng = np.random.RandomState(4)
    img = (rng.rand(31, 45) * 7 - 2).astype(np.float32)
    monkeypatch.chdir(tmp_path)
    outputs.save_sum_png(img, "s")
    px = decode_png("s_sum.png")
    assert px.shape == (31, 45, 3)
    normed = (img.astype(np.float64) - img.min()) / (img.max() - img.min())
    np.testing.assert_array_equal(px, outputs.jet_bytes(normed))
    matplotlib = pytest.importorskip("matplotlib")
    grid = np.linspace(0.0, 1.0, 1001)
    np.testing.assert_array_equal(
        outputs.jet_bytes(grid),
        matplotlib.colormaps["jet"](grid, bytes=True)[:, :3])
    np.testing.assert_array_equal(
        px, matplotlib.colormaps["jet"](normed, bytes=True)[..., :3])


def test_name_parsers_and_calibration_cube(tmp_path):
    for name in ("08_18_2018_enc_5_fov_3_405.czi", "run_enc_1023_488.npy",
                 "a_fov_12_561.tif", "plain_633.tiff", "x.npy"):
        assert tables.sample_from_image_name(name) \
            == jtables.sample_from_image_name(name)
    for name in ("08_18_2018_enc_5_fov_3", "mix_enc_77_fov_1"):
        assert tables.parse_encoding(name) == jtables.parse_encoding(name)
        assert tables.parse_fov(name) == jtables.parse_fov(name)
    with pytest.raises(ValueError):
        tables.parse_fov("no_tag")
    cal = np.random.RandomState(5).rand(12, 9).astype(np.float32) + 0.5
    np.testing.assert_array_equal(
        images.build_calibration_cube(cal, 95, 32),
        jimages.build_calibration_cube(cal, 95, 32))
    np.save(tmp_path / "cal.npy", cal)
    np.testing.assert_array_equal(
        images.load_calibration_image(str(tmp_path / "cal.npy")), cal)
    plane = np.random.RandomState(6).rand(8, 8, 3).astype(np.float32)
    np.save(tmp_path / "p_488.npy", plane)
    (got,) = images.load_image_stack([str(tmp_path / "p_488.npy")])
    np.testing.assert_array_equal(got, plane)


def test_unported_inputs_raise(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        images.load_image("fov_405.czi")
    with pytest.raises(ValueError):
        images.load_image("fov_405.png")
    (tmp_path / "probes.csv").write_text("target_taxon,code\n100,0000001\n")
    for laser in ("488", "514", "561", "633"):
        (tmp_path / f"stack_{laser}.czi").write_bytes(b"")
    with pytest.raises(ValueError, match="stack_488.czi: truncated"):
        cli_biofilm.main([
            str(tmp_path), "-d", "3", "-p", str(tmp_path / "probes.csv"),
            "-r", os.path.join(os.path.dirname(__file__), "fixtures",
                               "torch_port_clf_7b_127x50.npz"),
            "--device", "cpu"])
    with pytest.raises(ValueError, match="stack_488.czi: truncated"):
        images.load_image_zstack_fixed_t(str(tmp_path / "stack_488.czi"))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "clf_umap_transform.pkl").write_bytes(b"")
    (tmp_path / "clf_umap_transform_biofilm_7b.pkl").write_bytes(b"")
    # the reference's UMAP pickles take the legacy routes, whose reader
    # refuses an empty pickle
    np.savetxt("x_avgint.csv", np.ones((1, 95)), delimiter=",")
    outputs.save_avgint_norm_csv_with_header("x_avgint_norm.csv",
                                             np.ones((1, 63), np.float32))
    np.save("x_seg.npy", np.ones((4, 4), np.int32))
    with pytest.raises(ValueError, match="clf_umap_transform.pkl: an empty"):
        cli_classify.main(["x_avgint.csv", "-rf", "clf_umap_transform.pkl",
                           "--device", "cpu"])
    with pytest.raises(ValueError, match="biofilm_7b.pkl: an empty"):
        cli_classify_spectra.main(
            ["-i", "x_avgint_norm.csv", "-r",
             "clf_umap_transform_biofilm_7b.pkl", "--device", "cpu"])
    assert cli.resolve_classifier_path("a/b.pkl") == "a/b.npz"
    assert os.path.basename(cli.resolve_classifier_path("c.npz")) == "c.npz"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
def test_cuda_device_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.resolve_device("cuda")
    assert cli.resolve_device("cpu") == torch.device("cpu")
