"""Port parity for the collectors (hiprfish_tpu_torch/pipeline/collect.py
and cli/collect.py): the JAX package's collect and the port's, each on the
same data directory and experiment table, write byte-identical
_results.csv and _abundance.csv files.

The tables carry the cases pandas types or fills in its own way: a row
whose _cell_ids.txt is missing (the per-row columns NaN, written empty),
a zero-error sample (ErrorRateUpperLimit 'T'), a FOV with no _avgint.csv
(NCells 0), an int SPC column, a float column with an empty field and a
text column with an empty field, cell ids with blank lines, and abundance
columns that stay int64 (every barcode counted) or become float64.
"""

import numpy as np
import pandas as pd
import pytest

from hiprfish_tpu.cli import collect as jcli
from hiprfish_tpu.pipeline import collect as jcollect
from hiprfish_tpu_torch.cli import collect as cli
from hiprfish_tpu_torch.pipeline import collect


def _write_ids(path, codes, blank_every=0):
    with open(path, "w") as f:
        for k, c in enumerate(codes):
            f.write(c + "\n")
            if blank_every and k % blank_every == blank_every - 1:
                f.write("\n")


def _extra_columns(rows):
    """An int SPC, a float column with an empty field and a text column
    with an empty field."""
    for k, r in enumerate(rows):
        r["SPC"] = 120
        r["GAIN"] = "" if k == 1 else 0.25 * (k + 1)
        r["NOTE"] = "" if k == 0 else f"note {k}"
    return rows


def _mix_fixture(base_dir, rng, n_bits=10, codes=(5, 37, 515), every=False):
    """Three FOVs: two with cell ids (blank lines in the first), one with
    only an _avgint.csv; with ``every`` the first FOV holds every
    barcode. Returns (data_dir, table)."""
    data_dir = base_dir / "data"
    folder = data_dir / "mixrun"
    folder.mkdir(parents=True)
    rows = []
    for fov in (1, 2, 3):
        image_name = f"mix_3_fov_{fov}"
        n = 30
        if fov != 2:
            picked = list(rng.choice(codes, size=n))
            if every and fov == 1:
                picked = list(range(1, 2 ** n_bits)) + picked
                n = len(picked)
            _write_ids(folder / f"{image_name}_cell_ids.txt",
                       [format(int(c), f"0{n_bits}b") for c in picked],
                       blank_every=7 if fov == 1 else 0)
        np.savetxt(folder / f"{image_name}_avgint.csv", rng.rand(n, 95),
                   delimiter=",")
        rows.append({"SAMPLE": "mixrun", "IMAGES": image_name,
                     "CALIBRATION": "F", "CALIBRATION_FILENAME": "x",
                     "REFERENCE_FOLDER": "r"})
    table = base_dir / "images_table_mix_3.csv"
    pd.DataFrame(_extra_columns(rows)).to_csv(table, index=False)
    return data_dir, table


def _reference_fixture(base_dir, rng):
    """Four reference samples: zero errors ('T'), one-, two- and
    multi-bit errors ('F'), no _cell_ids.txt, and no _avgint.csv either.
    Returns (data_dir, table)."""
    data_dir = base_dir / "data"
    folder = data_dir / "refrun"
    folder.mkdir(parents=True)
    rows = []
    for k, enc in enumerate((5, 37, 515, 1023)):
        image_name = f"08_18_2018_enc_{enc}"
        code = format(enc, "010b")
        n = 25 + k
        if k == 0:
            ids = [code] * n
        elif k == 1:
            flips = [[0], [1, 2], [3, 4, 5], [9], [0, 9]]
            ids = [code] * (n - len(flips))
            for f in flips:
                bits = list(code)
                for b in f:
                    bits[b] = "1" if bits[b] == "0" else "0"
                ids.append("".join(bits))
            ids = list(rng.permutation(ids))
        if k < 2:
            _write_ids(folder / f"{image_name}_cell_ids.txt", ids,
                       blank_every=5)
        if k < 3:
            np.savetxt(folder / f"{image_name}_avgint.csv",
                       rng.rand(n, 95), delimiter=",")
        rows.append({"SAMPLE": "refrun", "IMAGES": image_name,
                     "CALIBRATION": "F", "CALIBRATION_FILENAME": "none",
                     "REFERENCE_FOLDER": "ref"})
    table = base_dir / "images_table.csv"
    pd.DataFrame(_extra_columns(rows)).to_csv(table, index=False)
    return data_dir, table


def _same_bytes(a, b):
    assert a.read_bytes() == b.read_bytes(), (a.read_text(), b.read_text())


def test_bit_error_counts_equals_jax(rng):
    expected = "0101100111"
    measured = ["".join(rng.choice(["0", "1"], 10)) for _ in range(200)]
    assert collect.bit_error_counts(np.array(measured, dtype=object),
                                    expected) \
        == jcollect.bit_error_counts(pd.Series(measured), expected)


def test_collect_reference_byte_identical(tmp_path, rng):
    data_dir, table = _reference_fixture(tmp_path, rng)
    got = collect.collect_reference_measurement_results(
        str(data_dir), str(table), str(tmp_path / "port_results.csv"))
    want = jcollect.collect_reference_measurement_results(
        str(data_dir), str(table), str(tmp_path / "jax_results.csv"))
    _same_bytes(tmp_path / "port_results.csv", tmp_path / "jax_results.csv")
    assert list(got) == list(want.columns)
    assert list(got["ErrorRateUpperLimit"][:2]) == ["T", "F"]
    assert np.isnan(got["ErrorRate"][2:]).all()
    assert list(got["NCells"]) == [25, 26, 27, 0]
    assert got["GAIN"].dtype == np.float64 and np.isnan(got["GAIN"][1])
    assert got["SPC"].dtype == np.int64


@pytest.mark.parametrize("n_bits,every", [(10, False), (3, True),
                                          (3, False)])
def test_collect_mix_byte_identical(tmp_path, rng, n_bits, every):
    codes = (5, 37, 515) if n_bits == 10 else (1, 3, 6)
    data_dir, table = _mix_fixture(tmp_path, rng, n_bits, codes, every)
    n_barcodes = 2 ** n_bits - 1
    for side, fn in (("port", collect.collect_mix_measurement_results),
                     ("jax", jcollect.collect_mix_measurement_results)):
        fn(str(data_dir), str(table), str(tmp_path / f"{side}_results.csv"),
           n_barcodes)
    for suffix in ("_results.csv", "_results_abundance.csv"):
        _same_bytes(tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}")
    header = (tmp_path / "port_results_abundance.csv").read_text() \
        .splitlines()[0]
    # FOV 2 has no ids: its column is left out, the names keep the rows'
    assert header == "Barcodes,FOV1,FOV3"
    first = (tmp_path / "port_results_abundance.csv").read_text() \
        .splitlines()[1].split(",")
    assert ("." in first[1]) != every     # int64 only when all counted


@pytest.mark.parametrize("mode", ["R", "M"])
def test_collect_cli_byte_identical(tmp_path, rng, mode):
    make = _reference_fixture if mode == "R" else _mix_fixture
    data_dir, table = make(tmp_path, rng)
    cli.main([str(data_dir), str(table), str(tmp_path / "port.csv"),
              "-t", mode])
    jcli.main([str(data_dir), str(table), str(tmp_path / "jax.csv"),
               "-t", mode])
    _same_bytes(tmp_path / "port.csv", tmp_path / "jax.csv")
    if mode == "M":
        _same_bytes(tmp_path / "port_abundance.csv",
                    tmp_path / "jax_abundance.csv")


@pytest.mark.parametrize("fn", [
    collect.collect_reference_measurement_results,
    jcollect.collect_reference_measurement_results])
def test_empty_avgint_raises(tmp_path, rng, fn):
    """An empty _avgint.csv (a FOV with no cell) raises in both packages,
    as pandas' EmptyDataError (a ValueError) does."""
    data_dir, table = _reference_fixture(tmp_path, rng)
    (data_dir / "refrun" / "08_18_2018_enc_5_avgint.csv").write_text("")
    with pytest.raises(ValueError):
        fn(str(data_dir), str(table), str(tmp_path / "out.csv"))
