"""Port parity for the volumetric biofilm analysis: the port's cli.biofilm
main([..., "-d", "3", "--device", "cpu"]) and the JAX package's cli.biofilm
main([..., "-d", "3"]) on the same per-laser z-stacks, each in its own
folder: the jittered 96 x 72 x 40 volume of
tests/test_torch_segment3d_volume.py (9 cells, lasers 2-4 rolled), stored
as (Z, X, Y, C_l) .npy stacks, with a probe design of its planted codes.

_seg.npy, _registered.npy and _identification.npy are equal, every .bvox
and the taxon colour lookup byte-identical, and _cell_information.csv
byte-identical but for the max_probability column (rtol 1e-4,
tests/test_torch_biofilm.py::same_csv); the port's table calls every
planted code.
"""

import csv
import os

import numpy as np
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu_torch.cli import biofilm as cli
from tests.test_torch_biofilm import FIXTURE, same_csv, write_probe_design
from tests.test_torch_segment3d_volume import JITTER_SPEC, jittered_volume

torch.set_num_threads(1)

SAMPLE = "stacks/vol"
NPY = ("_seg.npy", "_registered.npy", "_identification.npy")
BVOX = ("_raw_image.bvox", "_identification_r.bvox",
        "_identification_g.bvox", "_identification_b.bvox")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both command lines with -d 3 on the stacks: ({side: folder},
    truth labels, planted codes)."""
    from hiprfish_tpu.cli import biofilm as jcli

    blocks, truth, codes = jittered_volume()
    root = tmp_path_factory.mktemp("biofilm3d_cli")
    probes = str(root / "probes.csv")
    write_probe_design(probes, [int(c) for c in codes])
    out = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        os.makedirs(root / side / "stacks")
        for laser, block in zip(JSEVEN_BIT.lasers, blocks):
            np.save(root / side / f"{SAMPLE}_{laser}.npy",
                    np.ascontiguousarray(np.moveaxis(block, 2, 0)))
        # the same relative folder on both sides: the sample column holds
        # the folder as given
        old = os.getcwd()
        try:
            os.chdir(root / side)
            main(["stacks", "-p", probes, "-r", FIXTURE, "-d", "3",
                  "--max_cells", "64", *extra])
        finally:
            os.chdir(old)
        out[side] = root / side
    return out, truth, codes


@pytest.mark.parametrize("suffix", NPY)
def test_cli_3d_npy_artifacts_equal_jax(runs, suffix):
    folders = runs[0]
    got = np.load(folders["port"] / f"{SAMPLE}{suffix}")
    want = np.load(folders["jax"] / f"{SAMPLE}{suffix}")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", BVOX)
def test_cli_3d_bvox_byte_identical(runs, suffix):
    folders = runs[0]
    got = (folders["port"] / f"{SAMPLE}{suffix}").read_bytes()
    assert got == (folders["jax"] / f"{SAMPLE}{suffix}").read_bytes()
    head = np.frombuffer(got[:16], "<i4").tolist()
    assert head == [*JITTER_SPEC.shape, 1]
    assert len(got) == 16 + 4 * int(np.prod(JITTER_SPEC.shape))


@pytest.mark.parametrize("name", ["vol_cell_information.csv",
                                  "taxon_color_lookup.csv"])
def test_cli_3d_tables_equal_jax(runs, name):
    folders = runs[0]
    same_csv(folders["port"] / "stacks" / name,
             folders["jax"] / "stacks" / name)


def test_cli_3d_calls_the_planted_codes(runs):
    folders, truth, codes = runs
    with open(folders["port"] / f"{SAMPLE}_cell_information.csv",
              newline="") as f:
        rows = list(csv.DictReader(f))
    seg = np.load(folders["port"] / f"{SAMPLE}_seg.npy")
    assert len(rows) == int(seg.max()) == len(codes)
    call = {int(r["label"]): r["cell_barcode"] for r in rows}
    for t, c in enumerate(codes, 1):
        labs = seg[(truth == t) & (seg > 0)]
        assert call[int(np.bincount(labs).argmax())] \
            == JSEVEN_BIT.code_str(int(c))
    assert {r["type"] for r in rows} == {"cell"}
    ident = np.load(folders["port"] / f"{SAMPLE}_identification.npy")
    assert ident.shape == (*JITTER_SPEC.shape, 3)
    assert ident.dtype == np.float32
