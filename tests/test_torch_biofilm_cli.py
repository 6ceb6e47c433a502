"""Port parity for the biofilm command line: the port's cli.biofilm
main([..., "--device", "cpu"]) and the JAX package's cli.biofilm main on
the same inputs, each in its own folder, at 192^2:

- -d 2 on the seed-5 FOV's four planes ('fovA_<laser>.npy'): every .npy
  artifact equal, every CSV byte-identical except the classifier's
  probability columns (tests/test_torch_biofilm.py::same_csv), the taxon
  colour lookup byte-identical, and the six planted codes called;
- -z 1 on a 192^2 x 3 z-stack built from those planes (per-z weights,
  fresh noise per z, lasers 2-4 rolled in x and y): the registered plane,
  labels, adjacency labels and identification image equal, the headerless
  cell table and the adjacency matrix byte-identical;
- the refusals: .czi inputs with -d 2, -z and -d 3 (ROADMAP §A.7). The
  volumetric analysis (-d 3 without -z) is held against the JAX command
  line in tests/test_torch_biofilm3d_cli.py.
"""

import os

import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu_torch.cli import biofilm as cli
from tests.test_torch_biofilm import (CODES, FIXTURE, fov_stack, same_csv,
                                      write_probe_design)

torch.set_num_threads(1)

MAX_CELLS = "64"
Z_SHIFTS = [(0, 0), (2, -1), (-1, 2), (1, 1)]


def _write_fov(folder):
    folder.mkdir(parents=True)
    for laser, plane in zip(JSEVEN_BIT.lasers, fov_stack()):
        np.save(folder / f"fovA_{laser}.npy", plane)


def _write_zstack(folder):
    """(Z=3, 192, 192, C_l) float32 stacks: the FOV's planes weighted 0.7,
    1.0, 0.7 along z plus fresh noise per z, lasers 2-4 rolled by their
    (x, y) shift."""
    folder.mkdir(parents=True)
    rng = np.random.RandomState(21)
    for laser, plane, (sx, sy) in zip(JSEVEN_BIT.lasers, fov_stack(),
                                      Z_SHIFTS):
        zs = [w * plane + rng.rand(*plane.shape).astype(np.float32) * 0.01
              for w in (0.7, 1.0, 0.7)]
        vol = np.roll(np.stack(zs).astype(np.float32), (sx, sy), (1, 2))
        np.save(folder / f"stackA_{laser}.npy", vol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both command lines with -d 2 on the FOV and -z 1 on the z-stack:
    {side: (fov folder, z-stack folder)}."""
    from hiprfish_tpu.cli import biofilm as jcli

    root = tmp_path_factory.mktemp("biofilm_cli")
    probes = str(root / "probes.csv")
    write_probe_design(probes)
    out = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        fov, zst = root / side / "fov", root / side / "zstack"
        _write_fov(fov)
        _write_zstack(zst)
        common = ["-p", probes, "-r", FIXTURE, "--max_cells", MAX_CELLS]
        # the same relative folders on both sides: the sample column
        # holds the folder as given
        old = os.getcwd()
        try:
            os.chdir(root / side)
            main(["fov", *common, "-d", "2", *extra])
            main(["zstack", *common, "-z", "1", *extra])
        finally:
            os.chdir(old)
        out[side] = (fov, zst)
    return out


@pytest.mark.parametrize("suffix", [
    "_registered.npy", "_seg.npy", "_adjacency_seg.npy",
    "_epithelial_area.npy", "_identification_filtered.npy"])
def test_cli_2d_npy_artifacts_equal_jax(runs, suffix):
    got = np.load(runs["port"][0] / f"fovA{suffix}")
    want = np.load(runs["jax"][0] / f"fovA{suffix}")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", [
    "_avgint.csv", "_avgint_filtered.csv", "_cell_information.csv",
    "_cell_information_filtered.csv", "_adjacency_matrix.csv",
    "_adjacency_matrix_filtered.csv"])
def test_cli_2d_csv_artifacts_equal_jax(runs, suffix):
    same_csv(runs["port"][0] / f"fovA{suffix}",
             runs["jax"][0] / f"fovA{suffix}")


def test_cli_taxon_color_lookup_equals_jax(runs):
    for k in (0, 1):
        name = "taxon_color_lookup.csv"
        assert (runs["port"][k] / name).read_bytes() \
            == (runs["jax"][k] / name).read_bytes()


def test_cli_2d_calls_the_planted_codes(runs):
    import csv

    rows = list(csv.DictReader(open(runs["port"][0]
                                    / "fovA_cell_information.csv")))
    assert sorted(r["cell_barcode"] for r in rows) \
        == sorted(JSEVEN_BIT.code_str(c) for c in CODES)
    assert all(r["type"] == "cell" for r in rows)
    assert (runs["port"][0] / "fovA_identification.png").stat().st_size > 0


@pytest.mark.parametrize("suffix", [
    "_registered.npy", "_seg.npy", "_adjacency_seg.npy",
    "_identification.npy"])
def test_cli_zslice_npy_artifacts_equal_jax(runs, suffix):
    got = np.load(runs["port"][1] / f"stackA_z_1{suffix}")
    want = np.load(runs["jax"][1] / f"stackA_z_1{suffix}")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if suffix == "_seg.npy":
        assert got.max() == len(CODES)


@pytest.mark.parametrize("suffix", ["_cell_information.csv",
                                    "_adjacency_matrix.csv"])
def test_cli_zslice_csv_artifacts_equal_jax(runs, suffix):
    got = (runs["port"][1] / f"stackA_z_1{suffix}").read_bytes()
    assert got == (runs["jax"][1] / f"stackA_z_1{suffix}").read_bytes()


def test_cli_refusals(tmp_path):
    write_probe_design(tmp_path / "probes.csv")
    common = ["-p", str(tmp_path / "probes.csv"), "-r", FIXTURE,
              "--device", "cpu"]
    czi = tmp_path / "czi"
    czi.mkdir()
    for laser in JSEVEN_BIT.lasers:
        (czi / f"x_{laser}.czi").write_bytes(b"")
    for flags in (["-d", "2"], ["-z", "0"], ["-d", "3"]):
        with pytest.raises(NotImplementedError, match="§A.7"):
            cli.main([str(czi), *common, *flags])
    assert cli.samples_in(str(czi)) == [os.path.join(str(czi), "x")]
