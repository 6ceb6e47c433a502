"""Port parity for the summaries (hiprfish_tpu_torch/pipeline/summarize.py
and the figure CLIs): the same files through the JAX package's functions
and the port's give the same numbers bit for bit (hamming, the bootstrap
mean, mean abundance, the titration regression and its merged table, both
cell_information schemas, the multispecies error-rate tables), and the
port's CLIs write their PDFs while matplotlib is present.

The setups are tests/test_cli_surface.py's (titration, multispecies) and
tests/test_misc_components.py's (abundance, cell_information schemas).
"""

import numpy as np
import pandas as pd
import pytest

from hiprfish_tpu.pipeline import summarize as jsummarize
from hiprfish_tpu_torch.cli import analyze_multispecies as cli_ms
from hiprfish_tpu_torch.cli import summarize_mix as cli_mix
from hiprfish_tpu_torch.cli import summarize_titration as cli_t
from hiprfish_tpu_torch.pipeline import summarize


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint64),
                                      want.view(np.uint64))
    else:
        np.testing.assert_array_equal(got, want)


def _same_frame(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns)
    for name in want.columns:
        col = want[name].to_numpy()
        if col.dtype == object:
            assert list(got[name]) == list(col), name
        else:
            _bitwise(got[name], col)


def test_hamming_and_bootstrap_bitwise(rng):
    a, b = "0101100111", "1101000110"
    assert summarize.hamming(a, b) == jsummarize.hamming(a, b) == 3
    values = rng.rand(50)
    for n_boot, seed in ((200, 0), (1000, 3)):
        got = summarize.bootstrap_estimate_mean(values, n_boot, seed)
        want = jsummarize.bootstrap_estimate_mean(values, n_boot, seed)
        _bitwise(got, want)


@pytest.mark.parametrize("n_fovs", [2, 11])
def test_mean_abundance_bitwise(tmp_path, rng, n_fovs):
    """int64 FOV columns (every barcode counted) beside float64 ones, and
    more FOVs than numpy's 8-wide pairwise blocks, so the reductions must
    add in pandas' column-major order."""
    ab = pd.DataFrame({"Barcodes": np.arange(1, 1024)})
    for k in range(n_fovs):
        col = rng.randint(0, 5, 1023)
        ab[f"FOV{k + 1}"] = col if k % 2 else col.astype(float)
    p = tmp_path / "x_results_abundance.csv"
    ab.to_csv(p, index=False)
    _same_frame(summarize.mean_abundance(str(p)),
                jsummarize.mean_abundance(str(p)))


def _titration_files(tmp_path, mix_ids=(3,), scale=1.0):
    """tests/test_cli_surface.py:55-80's setup, per mix id, with one
    barcode at input 0 and a duplicated input row."""
    conc = {5: 1.0, 37: 2.0, 515: 4.0, 96: 0.0}
    for m in mix_ids:
        ab = pd.DataFrame({"Barcodes": np.arange(1, 1024)})
        for fov in (1, 2):
            col = np.zeros(1023, int)
            for code, c in conc.items():
                col[code - 1] = int(40 * c * scale * m) + fov
            ab[f"FOV{fov}"] = col
        ab.to_csv(tmp_path / f"images_table_mix_{m}_results_abundance.csv",
                  index=False)
        pd.DataFrame({
            "Barcodes": [515, 5, 37, 96, 37],
            "InputConcentration": [4.0, 1.0, 2.0, 0.0, 2.0],
        }).to_csv(tmp_path / f"images_table_mix_{m}.csv", index=False)


def test_titration_correlation_bitwise(tmp_path):
    _titration_files(tmp_path, mix_ids=(3, 4))
    pattern = str(tmp_path / "images_table_mix_*_results_abundance.csv")
    got = summarize.titration_correlation(pattern)
    want = jsummarize.titration_correlation(pattern)
    for key in ("slope", "intercept", "rvalue", "gross_error_rate"):
        _bitwise(got[key], want[key])
    _same_frame(got["table"], want["table"])
    assert got["slope"] > 0 and got["rvalue"] > 0.99
    assert summarize.titration_correlation(
        str(tmp_path / "none_*_results_abundance.csv")) is None


def test_read_cell_information_both_schemas(tmp_path, rng):
    """tests/test_misc_components.py's files: headerless 7-bit (with an
    _error call) and the named biofilm schema."""
    n = 12
    spectra = rng.rand(n, 63)
    checks = rng.randint(0, 2, (n, 4)).astype(float)
    codes = ["0101010"] * (n - 1) + ["0101011_error"]
    meta = np.column_stack([
        np.array(["s"] * n), np.arange(1, n + 1),
        rng.rand(n), rng.rand(n), rng.rand(n), rng.rand(n),
        rng.rand(n), rng.rand(n), rng.randint(60, 900, n)])
    p7 = tmp_path / "a_7b_cell_information.csv"
    pd.DataFrame(np.column_stack(
        [spectra, checks, np.array(codes)[:, None], meta])).to_csv(
        p7, index=None, header=None)
    bio = pd.DataFrame(rng.rand(n, 63),
                       columns=[f"channel_{i}" for i in range(63)])
    for c in range(4):
        bio[f"check_{c}"] = checks[:, c]
    bio["cell_barcode"] = ["0011001"] * (n - 1) + ["0000011"]
    bio["max_probability"] = rng.rand(n)
    bio["sample"] = "s"
    pb = tmp_path / "b_cell_information.csv"
    bio.to_csv(pb, index=None)
    nowhere = tmp_path / "c_cell_information.csv"
    pd.DataFrame(rng.rand(n, 5)).to_csv(nowhere, index=None, header=None)
    for path in (p7, pb):
        barcodes, spec = summarize._read_cell_information(str(path), 7)
        jbarcodes, jspec = jsummarize._read_cell_information(str(path), 7)
        assert list(barcodes) == list(jbarcodes)
        _bitwise(spec, jspec.values)
    assert summarize._read_cell_information(str(nowhere), 7) == (None, None)
    assert jsummarize._read_cell_information(str(nowhere), 7) \
        == (None, None)


def _multispecies_files(tmp_path, rng):
    """tests/test_cli_surface.py:83-113's setup, with one wrong call, a
    dim cell, a duplicated probe row and a taxon without files."""
    taxids = [564, 1718]
    expected = {564: "0101010", 1718: "1010101"}
    probe_paths = []
    for enc_set in ("B", "C", "A"):
        for t in taxids:
            n = 10
            spectra = rng.rand(n, 63) * 0.5 + 0.5
            spectra[0] *= 0.1
            checks = rng.randint(0, 2, (n, 4)).astype(float)
            meta = np.column_stack([
                np.array(["s"] * n), np.arange(1, n + 1),
                rng.rand(n), rng.rand(n), rng.rand(n), rng.rand(n),
                rng.rand(n), rng.rand(n), rng.randint(60, 900, n)])
            calls = np.array([expected[t]] * n)
            if t == 564 and enc_set != "A":
                calls[3] = "0101011_error"
            pd.DataFrame(np.column_stack(
                [spectra, checks, calls[:, None], meta])).to_csv(
                tmp_path / f"x_{enc_set}_{t}_fov_1_cell_information.csv",
                index=None, header=None)
        p = tmp_path / f"probes_{enc_set}.csv"
        pd.DataFrame({"target_taxon": taxids + [564, 33],
                      "code": [expected[t] for t in taxids]
                      + [expected[564], "0000111"]}).to_csv(p, index=False)
        probe_paths.append(str(p))
    return probe_paths


def test_summarize_multispecies_error_rate_every_column(tmp_path, rng):
    probe_paths = _multispecies_files(tmp_path, rng)
    got = summarize.summarize_multispecies_error_rate(str(tmp_path),
                                                      probe_paths)
    want = jsummarize.summarize_multispecies_error_rate(str(tmp_path),
                                                        probe_paths)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_frame(g, w)
    # B: one wrong call of 564; A: no errors, so the 1/N upper limit
    assert got[0]["ErrorRate"][0] > 0 and got[0]["UpperLimit"][0] == 0
    assert list(got[2]["UpperLimit"][:2]) == [1, 1]


def test_plot_representative_cell_spectra_stats(tmp_path, rng):
    _multispecies_files(tmp_path, rng)
    got = summarize.plot_representative_cell_spectra(str(tmp_path))
    want = jsummarize.plot_representative_cell_spectra(str(tmp_path))
    assert set(got) == set(want)
    for key in want:
        for g, w in zip(got[key], want[key]):
            _bitwise(g, w)


def test_figure_clis_write_pdfs(tmp_path, rng):
    """The port's summarize_mix, summarize_titration and
    analyze_multispecies on those setups; analyze_multispecies prints
    each encoding set's table."""
    ab = pd.DataFrame({"Barcodes": np.arange(1, 1024),
                       "FOV1": rng.randint(0, 5, 1023),
                       "FOV3": rng.randint(0, 5, 1023)})
    mix = tmp_path / "mix"
    mix.mkdir()
    ab.to_csv(mix / "images_table_mix_0_results_abundance.csv", index=False)
    cli_mix.main([str(mix / "images_table_mix_0_results_abundance.csv")])
    for suffix in ("_barcodes.pdf", "_distribution.pdf"):
        assert (mix / f"images_table_mix_0_results_abundance{suffix}") \
            .stat().st_size > 0
    tit = tmp_path / "tit"
    tit.mkdir()
    _titration_files(tit, mix_ids=(3, 4))
    cli_t.main([str(tit), "-m", "3"])
    cli_t.main([str(tit)])
    assert (tit / "titration_mix_3.pdf").stat().st_size > 0
    assert (tit / "titration_all.pdf").stat().st_size > 0
    ms = tmp_path / "ms"
    ms.mkdir()
    probe_paths = _multispecies_files(ms, rng)
    summaries = cli_ms.main([str(ms), "-p", *probe_paths])
    assert (ms / "multispecies_error_rate.pdf").stat().st_size > 0
    assert (ms / "multispecies_representative_cell_spectra.pdf") \
        .stat().st_size > 0
    text = cli_ms.format_table(summaries[0]).splitlines()
    assert text[0].split() == ["target_taxon", "code", "ErrorRate",
                               "UpperLimit", "EncodingSet"]
    assert len(text) == 1 + len(summaries[0]["code"])
