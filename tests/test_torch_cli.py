"""Port parity for the four command lines: each port CLI's main([...,
"--device", "cpu"]) and the JAX CLI's main on the same .npy planes, each
in its own directory, give the same artifacts.

- 10-bit, 192^2 (tests/test_full_pipeline.py's FOV recipe, nine distinct
  codes): measure with -c F and with -c T -cf <smooth flat field>; equal
  _seg.npy, byte-identical _avgint.csv and _avgint_norm.csv (the float32
  scatter sums add in the same order on both sides, and the port divides
  the sums once by count x row max, as XLA folds the reference's two
  divisions); then classify with the committed 1023-class fixture on the
  same measured files: equal _cell_ids.txt, byte-identical
  _avgint_ids.csv.
- 7-bit, 192^2 (tests/test_cli_surface.py's multispecies FOV):
  measure_multispecies: equal _seg.npy and _registered.npy,
  byte-identical _avgint_norm.csv; classify_spectra with the committed
  127-code fixture: byte-identical _cell_information.csv (the shape
  columns' second moments round once per multiply-add on both sides).
- The PNGs decode to label2rgb / jet pixels (the JAX renders are
  matplotlib figures of another size and are not compared).
- measure_reference_images(engine="fused") on the CPU against the JAX
  fused engine followed by measure_fov.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.config import TEN_BIT as JTEN_BIT
from hiprfish_tpu.io import outputs as joutputs
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.pipeline import classify
from tests.test_torch_io import decode_png

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CLF_10B = os.path.join(FIXTURES, "torch_port_clf_10b_1023x200.npz")
CLF_7B = os.path.join(FIXTURES, "torch_port_clf_7b_127x50.npz")
CODES_10B = [5, 37, 515, 96, 640, 17, 260, 770, 1023]
CODES_7B = [1, 9, 65, 127, 34, 88]
MAX_CELLS = 64


class _InDir:
    """chdir into a directory for the duration of a with block."""

    def __init__(self, path):
        self.path, self.old = str(path), None

    def __enter__(self):
        self.old = os.getcwd()
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _write_planes(folder, layout, fov, sample):
    folder.mkdir(parents=True, exist_ok=True)
    names = []
    for laser, plane in zip(layout.lasers, fov["stack"]):
        names.append(f"{sample}_{laser}.npy")
        np.save(folder / names[-1], plane)
    return names


def _copy(names, src, dst):
    dst.mkdir(parents=True, exist_ok=True)
    for n in names:
        shutil.copy(src / n, dst / n)


def _same_bytes(a, b):
    assert a.read_bytes() == b.read_bytes(), (a, b)


@pytest.fixture(scope="module")
def ecoli(tmp_path_factory):
    """The 10-bit FOV's planes, a flat-field image, and both measure CLIs
    run on them with -c F and -c T: {cal: (port dir, jax dir)}."""
    from hiprfish_tpu.cli import measure as jcli
    from hiprfish_tpu_torch.cli import measure as cli

    root = tmp_path_factory.mktemp("ecoli")
    fov = jsynthetic.make_fov(
        JTEN_BIT, CODES_10B, shape=(192, 192), seed=1,
        laser_shifts=[(0, 0), (1, -1), (0, 1), (-1, 0), (1, 1)],
        cell_axes=(9.0, 14.0))
    names = _write_planes(root / "planes", JTEN_BIT, fov, "run_enc_5")
    yy, xx = np.mgrid[:192, :192].astype(np.float32)
    np.save(root / "planes" / "cal.npy",
            (0.8 + 0.2 * np.cos(yy / 60.0) * np.sin(xx / 45.0 + 0.3))
            .astype(np.float32))
    dirs = {}
    for cal in ("F", "T"):
        flags = ["-c", cal, "--max_cells", str(MAX_CELLS)]
        if cal == "T":
            flags += ["-cf", "cal.npy"]
        pair = []
        for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                                  ("jax", jcli.main, [])):
            d = root / f"{side}_{cal}"
            _copy(names + ["cal.npy"], root / "planes", d)
            with _InDir(d):
                if side == "jax" and cal == "T":
                    _jax_measure_calibrated(names, "cal.npy")
                else:
                    main(["-i", *names, *flags, *extra])
            pair.append(d)
        dirs[cal] = tuple(pair)
    return {"fov": fov, "dirs": dirs}


def _jax_measure_calibrated(names, cal_file):
    """The JAX measure CLI's host-engine branch with -c T, step by step:
    its main raises UnboundLocalError there (a local import of jnp in the
    accelerator branch shadows the module's), so the test runs its
    statements (hiprfish_tpu/cli/measure.py:26-62) itself."""
    import jax.numpy as jnp

    from hiprfish_tpu.config import SegmentationConfig as JCfg
    from hiprfish_tpu.io import images as jiio
    from hiprfish_tpu.io import tables as jtables
    from hiprfish_tpu.pipeline import measure as jmeasure
    from hiprfish_tpu.pipeline import segment2d as jsegment2d

    sample = jtables.sample_from_image_name(names[0])
    res = jsegment2d.segment_ecoli(jiio.load_image_stack(names), JCfg(),
                                   MAX_CELLS)
    cube = jiio.build_calibration_cube(jiio.load_calibration_image(cal_file),
                                       res.registered.shape[2],
                                       JTEN_BIT.block_bounds[1])
    avgint, norm = jmeasure.measure_fov(
        res.segmentation, res.registered / jnp.asarray(cube),
        int(res.n_cells), MAX_CELLS)
    jmeasure.save_measurement(sample, avgint, norm,
                              np.asarray(res.segmentation))


@pytest.mark.parametrize("cal", ["F", "T"])
def test_measure_cli_equals_jax(ecoli, cal):
    port, jax_dir = ecoli["dirs"][cal]
    seg = np.load(port / "run_enc_5_seg.npy")
    np.testing.assert_array_equal(seg, np.load(jax_dir / "run_enc_5_seg.npy"))
    assert seg.max() == len(CODES_10B)
    for suffix in ("_avgint.csv", "_avgint_norm.csv"):
        _same_bytes(port / f"run_enc_5{suffix}", jax_dir / f"run_enc_5{suffix}")
    np.testing.assert_array_equal(
        decode_png(port / "run_enc_5_seg.png"),
        np.round(255 * joutputs.label2rgb(seg)).astype(np.uint8))


def test_calibration_changes_the_405_block(ecoli):
    port_f, _ = ecoli["dirs"]["F"]
    port_t, _ = ecoli["dirs"]["T"]
    a = outputs.read_spectra_csv(str(port_f / "run_enc_5_avgint.csv"))
    b = outputs.read_spectra_csv(str(port_t / "run_enc_5_avgint.csv"))
    assert not np.allclose(a[:, :32], b[:, :32])
    np.testing.assert_array_equal(a[:, 32:], b[:, 32:])


def test_classify_cli_equals_jax(ecoli, tmp_path):
    """Both classifiers on the same measured files (the JAX CLI's)."""
    from hiprfish_tpu.cli import classify as jcli
    from hiprfish_tpu_torch.cli import classify as cli

    _, src = ecoli["dirs"]["F"]
    files = ["run_enc_5_avgint.csv", "run_enc_5_seg.npy"]
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        _copy(files, src, tmp_path / side)
        with _InDir(tmp_path / side):
            main(["run_enc_5_avgint.csv", "-rf", CLF_10B, *extra])
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    for suffix in ("_cell_ids.txt", "_avgint_ids.csv"):
        _same_bytes(port / f"run_enc_5{suffix}", jax_dir / f"run_enc_5{suffix}")
    codes = (port / "run_enc_5_cell_ids.txt").read_text().split()
    assert sorted(codes) == sorted(JTEN_BIT.code_str(c) for c in CODES_10B)
    seg = np.load(port / "run_enc_5_seg.npy")
    ident = classify.paint_identification(seg, codes, len(codes))
    np.testing.assert_array_equal(
        decode_png(port / "run_enc_5_identification.png"),
        np.round(255 * joutputs.label2rgb(ident)).astype(np.uint8))


def test_fused_engine_on_cpu_equals_jax(ecoli, tmp_path):
    """engine="fused" on the CPU against the JAX fused engine followed by
    measure_fov, on the same planes (bf16 cube on both sides)."""
    import jax.numpy as jnp

    from hiprfish_tpu.config import SegmentationConfig as JCfg
    from hiprfish_tpu.pipeline import fused_ecoli as jfused_ecoli
    from hiprfish_tpu.pipeline import measure as jmeasure
    from hiprfish_tpu_torch.cli import measure as cli

    stack = ecoli["fov"]["stack"]
    seg_j, n_j, reg_j, _ = jfused_ecoli.segment_ecoli_device(
        tuple(jnp.asarray(a) for a in stack), JCfg(), MAX_CELLS)
    avg_j, _ = jmeasure.measure_fov(seg_j, reg_j, int(n_j), MAX_CELLS)
    names = _write_planes(tmp_path, JTEN_BIT, ecoli["fov"], "fused_enc_5")
    with _InDir(tmp_path):
        seg, avg = cli.measure_reference_images(
            names, "F", max_cells=MAX_CELLS, device="cpu", engine="fused")
    assert int(seg.max()) == int(n_j) == len(CODES_10B)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_j))
    np.testing.assert_allclose(avg, np.asarray(avg_j), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(np.load(tmp_path / "fused_enc_5_seg.npy"),
                                  seg.numpy())


@pytest.fixture(scope="module")
def multispecies(tmp_path_factory):
    """Both multispecies measure CLIs on the 7-bit FOV's planes."""
    from hiprfish_tpu.cli import measure_multispecies as jcli
    from hiprfish_tpu_torch.cli import measure_multispecies as cli

    root = tmp_path_factory.mktemp("seven")
    fov = jsynthetic.make_fov(JSEVEN_BIT, CODES_7B, shape=(192, 192), seed=5,
                              cell_axes=(7.0, 12.0))
    names = _write_planes(root / "planes", JSEVEN_BIT, fov, "sampleA")
    out = []
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        _copy(names, root / "planes", root / side)
        with _InDir(root / side):
            main(["-i", *names, "--max_cells", str(MAX_CELLS), *extra])
        out.append(root / side)
    return tuple(out)


def test_measure_multispecies_cli_equals_jax(multispecies):
    port, jax_dir = multispecies
    seg = np.load(port / "sampleA_seg.npy")
    np.testing.assert_array_equal(seg, np.load(jax_dir / "sampleA_seg.npy"))
    assert seg.max() == len(CODES_7B)
    np.testing.assert_array_equal(np.load(port / "sampleA_registered.npy"),
                                  np.load(jax_dir / "sampleA_registered.npy"))
    _same_bytes(port / "sampleA_avgint_norm.csv",
                jax_dir / "sampleA_avgint_norm.csv")
    np.testing.assert_array_equal(
        decode_png(port / "sampleA_seg.png"),
        np.round(255 * joutputs.label2rgb(seg)).astype(np.uint8))
    fov_sum = np.load(port / "sampleA_registered.npy").sum(axis=2)
    for suffix in ("_sum.png", "_enhanced.png"):
        px = decode_png(port / f"sampleA{suffix}")
        assert px.shape == (192, 192, 3)
    # the sum render is jet over the min-max normalised channel sum (up to
    # the summation order of the 63 channels)
    want = outputs.jet_bytes(outputs.minmax_normalize(fov_sum))
    assert (decode_png(port / "sampleA_sum.png") != want).any(axis=2).mean() \
        < 1e-3


def test_classify_spectra_cli_equals_jax(multispecies, tmp_path):
    """Both 7-bit classifiers on the same measured files (the JAX CLI's)."""
    from hiprfish_tpu.cli import classify_spectra as jcli
    from hiprfish_tpu_torch.cli import classify_spectra as cli

    _, src = multispecies
    files = ["sampleA_avgint_norm.csv", "sampleA_seg.npy"]
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        _copy(files, src, tmp_path / side)
        with _InDir(tmp_path / side):
            main(["-i", "sampleA_avgint_norm.csv", "-r", CLF_7B, *extra])
    _same_bytes(tmp_path / "port" / "sampleA_cell_information.csv",
                tmp_path / "jax" / "sampleA_cell_information.csv")
    rows = (tmp_path / "port" / "sampleA_cell_information.csv").read_text() \
        .splitlines()
    assert len(rows) == len(CODES_7B)
    # 63 features + 4 check bits, then the barcode
    assert sorted(r.split(",")[67] for r in rows) \
        == sorted(JSEVEN_BIT.code_str(c) for c in CODES_7B)
