"""Experiment summary statistics and figures (the port of
hiprfish_tpu/pipeline/summarize.py, with numpy and the csv module in
place of pandas; a table is an ordered {column: numpy array}).

  * mix abundance plots: mean barcode abundance against the uniform
    1/n_barcodes expectation, and the abundance distribution;
  * titration correlation: input against measured abundance, a linear
    regression and the gross error rate at concentration 0, with the
    bootstrap mean estimate;
  * multispecies error rates and Hamming-distance distributions per taxon
    and encoding set.

scipy.stats and matplotlib are imported only inside the functions that
use them; without matplotlib a figure call raises ImportError.
"""

from __future__ import annotations

import csv
import glob
import os
import re

import numpy as np

from hiprfish_tpu_torch.io import outputs, tables


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def hamming(s1: str, s2: str) -> int:
    assert len(s1) == len(s2)
    return sum(a != b for a, b in zip(s1, s2))


def bootstrap_estimate_mean(values, n_boot: int = 1000, seed: int = 0):
    """Bootstrap mean +- std of the values' mean."""
    rng = np.random.RandomState(seed)
    values = np.asarray(values, float)
    means = np.array(
        [rng.choice(values, values.size, replace=True).mean()
         for _ in range(n_boot)]
    )
    return means.mean(), means.std()


def _frame_values(columns, n: int) -> np.ndarray:
    """n-row columns as one (n, k) array of their common dtype in
    column-major order, the layout of pandas' DataFrame.values
    (reductions over it add in pandas' order)."""
    if not columns:
        return np.zeros((n, 0))
    return np.stack(columns, axis=0).T


def mean_abundance(abundance_csv: str) -> dict:
    """Per-barcode mean and std of the relative abundance across the FOV
    columns: {Barcodes, MeanAbundance, StdAbundance}."""
    tab = tables.read_columns(abundance_csv)
    counts = _frame_values([v for c, v in tab.items()
                            if c.startswith("FOV")], len(tab["Barcodes"]))
    totals = counts.sum(axis=0, keepdims=True)
    rel = counts / np.maximum(totals, 1)
    return {"Barcodes": tab["Barcodes"],
            "MeanAbundance": rel.mean(axis=1),
            "StdAbundance": rel.std(axis=1)}


def plot_mean_abundance_barcodes(abundance_csv: str, output_pdf: str,
                                 n_barcodes: int = 1023) -> None:
    """Barcode vs mean abundance with the uniform 1/n expectation line."""
    plt = _pyplot()
    tab = mean_abundance(abundance_csv)
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(tab["Barcodes"], tab["MeanAbundance"], "o", markersize=2,
            alpha=0.7)
    ax.axhline(1 / n_barcodes, color="orangered", lw=1,
               label=f"uniform 1/{n_barcodes}")
    ax.set_xlabel("Barcode")
    ax.set_ylabel("Mean abundance")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(output_pdf, dpi=300)
    plt.close(fig)


def plot_mean_abundance_distribution(abundance_csv: str, output_pdf: str,
                                     n_barcodes: int = 1023) -> None:
    plt = _pyplot()
    tab = mean_abundance(abundance_csv)
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.hist(tab["MeanAbundance"], bins=50)
    ax.axvline(1 / n_barcodes, color="orangered", lw=1)
    ax.set_xlabel("Mean abundance")
    ax.set_ylabel("Barcodes")
    fig.tight_layout()
    fig.savefig(output_pdf, dpi=300)
    plt.close(fig)


def plot_avg_int_reference(avgint: np.ndarray, enc: int, output_pdf: str,
                           n_bits: int = 10) -> None:
    """Per-cell spectra overlay with the encoding annotation (the
    reference measurement's QC figure)."""
    plt = _pyplot()
    avgint = np.asarray(avgint)
    fig, ax = plt.subplots(figsize=(5, 3))
    for row in avgint:
        ax.plot(row, color="dodgerblue", alpha=0.3, lw=0.5)
    ax.plot(avgint.mean(axis=0), color="orangered", lw=1.5, label="mean")
    ax.set_xlabel("Channel")
    ax.set_ylabel("Intensity")
    ax.set_title(f"enc {enc} = {format(enc, f'0{n_bits}b')} "
                 f"({avgint.shape[0]} cells)", fontsize=9)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(output_pdf, dpi=300)
    plt.close(fig)


def apply_presentation_style() -> None:
    """White-on-transparent figure styling (the reference's
    *_presentation plot variants)."""
    import matplotlib

    matplotlib.rcParams.update({
        "text.color": "white",
        "axes.edgecolor": "white",
        "axes.labelcolor": "white",
        "xtick.color": "white",
        "ytick.color": "white",
        "savefig.transparent": True,
    })


def _inner_merge(left: dict, right: dict, key: str) -> dict:
    """pandas' ``left.merge(right, on=key)`` (inner): for each left row in
    order, one row per matching right row in the right's order."""
    where = {}
    for j, k in enumerate(right[key]):
        where.setdefault(k, []).append(j)
    li, ri = [], []
    for i, k in enumerate(left[key]):
        for j in where.get(k, ()):
            li.append(i)
            ri.append(j)
    li, ri = np.array(li, np.int64), np.array(ri, np.int64)
    out = {c: v[li] for c, v in left.items()}
    out.update({c: v[ri] for c, v in right.items() if c != key})
    return out


def titration_correlation(results_glob: str):
    """Input concentration vs measured abundance across mixes: a linear
    regression over the nonzero inputs and the gross error rate at
    concentration 0. Expects *_results_abundance.csv files beside the
    input tables, which carry an InputConcentration column per barcode.
    Returns {slope, intercept, rvalue, gross_error_rate, table} (the
    merged rows as a table), or None without any input table."""
    from scipy import stats as sstats

    rows = []
    for f in sorted(glob.glob(results_glob)):
        ab = mean_abundance(f)
        input_tab_path = re.sub(r"_results_abundance\.csv$", ".csv", f)
        if not os.path.exists(input_tab_path):
            continue
        inp = tables.read_columns(input_tab_path)
        if "Barcodes" not in inp or "InputConcentration" not in inp:
            continue
        rows.append(_inner_merge(ab, {
            "Barcodes": inp["Barcodes"],
            "InputConcentration": inp["InputConcentration"]}, "Barcodes"))
    if not rows:
        return None
    allrows = {c: np.concatenate([r[c] for r in rows]) for c in rows[0]}
    conc = allrows["InputConcentration"]
    nz = conc > 0
    reg = sstats.linregress(conc[nz], allrows["MeanAbundance"][nz])
    zero = allrows["MeanAbundance"][conc == 0]
    gross_error = (float(np.where(np.isnan(zero), 0.0, zero).sum())
                   if len(zero) else 0.0)
    return {
        "slope": reg.slope,
        "intercept": reg.intercept,
        "rvalue": reg.rvalue,
        "gross_error_rate": gross_error,
        "table": allrows,
    }


def plot_titration_correlation(results_glob: str, output_pdf: str):
    plt = _pyplot()
    res = titration_correlation(results_glob)
    if res is None:
        return None
    tab = res["table"]
    conc = tab["InputConcentration"]
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.loglog(conc, tab["MeanAbundance"], "o", markersize=3)
    xs = np.linspace(np.nanmin(conc) + 1e-12, np.nanmax(conc), 50)
    ax.plot(xs, res["slope"] * xs + res["intercept"], "-",
            color="orangered")
    ax.set_xlabel("Input abundance")
    ax.set_ylabel("Measured abundance")
    ax.set_title(f"r = {res['rvalue']:.3f}", fontsize=9)
    fig.tight_layout()
    fig.savefig(output_pdf, dpi=300)
    plt.close(fig)
    return res


_N_CHECKS_BY_NBITS = {7: 4, 10: 6}  # per-laser check-bit heads per layout


def _headerless_columns(path: str, column=tables.text_column) -> list:
    """The columns of a headerless CSV, each through ``column`` (text, as
    pandas' header=None, dtype=str reads them; tables.typed_column for
    pandas' types): as many as the first line has fields, missing fields
    empty; blank lines skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    width = len(rows[0]) if rows else 0
    return [column([r[j] if j < len(r) else "" for r in rows])
            for j in range(width)]


def _as_text(col) -> np.ndarray:
    """pandas' astype(str): NaN as 'nan'."""
    return np.array([str(v) for v in col], dtype=object)


def _read_cell_information(path: str, nbits: int):
    """Read one cell_information table and return (barcodes, spectra): the
    barcodes as text and the spectra as an (n, C) float64 array.

    Handles both on-disk schemas independently of the layout:
      * headerless 7-bit files: [n_channels spectra | n_checks check bits |
        barcode | metadata...]; the barcode column is the first whose
        values are all nbits-wide 0/1 strings (an '_error' suffix
        allowed), and the spectra end n_checks columns before it;
      * named biofilm files: 'cell_barcode' + 'channel_<i>'.
    Returns (None, None) when no barcode column can be identified.
    """
    with open(path, newline="") as f:
        header = next(csv.reader(f), [])
    if "cell_barcode" in header:
        df = tables.read_columns(path, ("cell_barcode",))
        chan_cols = [c for c in df if re.match(r"^channel_[0-9]+$", c)]
        spectra = _frame_values([df[c].astype(float) for c in chan_cols],
                                len(df["cell_barcode"]))
        return _as_text(df["cell_barcode"]), spectra
    cols = _headerless_columns(path)
    barcode_re = re.compile(r"^[01]{%d}(_error)?$" % nbits)
    code_col = None
    for j, col in enumerate(cols):
        vals = [str(v) for v in col if not tables.is_na(v)]
        if vals and all(barcode_re.match(v) for v in vals):
            code_col = j
            break
    if code_col is None:
        return None, None
    n_checks = _N_CHECKS_BY_NBITS.get(nbits, 0)
    spectra = _frame_values([c.astype(float)
                             for c in cols[: code_col - n_checks]],
                            len(cols[code_col]))
    return _as_text(cols[code_col]), spectra


DEFAULT_SCI_NAMES = {
    # the reference's 11-taxon synthetic community
    564: "E. coli", 1718: "C. glutamicum", 1590: "L. plantarum",
    140100: "V. albensis", 1580: "L. brevis", 438: "A. plantarum",
    104102: "A. tropicalis", 108981: "A. schindleri",
    285: "C. testosteroni", 1353: "E. gallinarum", 56459: "X. vasicola",
}

#: the reference's fixed taxon row order
DEFAULT_TAXON_ORDER = (108981, 140100, 56459, 104102, 1580, 1590, 1353, 438,
                       1718, 285, 564)


def plot_representative_cell_spectra(input_folder: str,
                                     encoding_sets=("A", "B", "C"),
                                     set_titles=("Random", "Least Complex",
                                                 "Most Complex"),
                                     block_bounds=(0, 23, 43, 57, 63),
                                     sci_names=None, taxon_order=None,
                                     output_pdf: str | None = None):
    """Per-taxon mean+/-std cell spectra in an (n_taxa, 2*n_sets) grid with
    the 4 laser blocks in the reference's colors. Taxa are discovered from
    the ``*_{set}_{taxid}_fov_*_cell_information.csv`` files (the
    reference's 11-taxon table is the default name map). Returns
    {(enc_set, taxid): (mean, std)} and writes the PDF when requested."""
    plt = _pyplot()
    from matplotlib.gridspec import GridSpec

    sci_names = DEFAULT_SCI_NAMES if sci_names is None else sci_names
    nchan = block_bounds[-1]
    colors = ["limegreen", "yellowgreen", "darkorange", "red"]

    stats = {}
    taxa_seen = []
    for enc_set in encoding_sets:
        for f in sorted(glob.glob(os.path.join(
                input_folder, f"*_{enc_set}_*_cell_information.csv"))):
            m = re.search(r"_([0-9]+)_fov_", os.path.basename(f))
            if not m:
                continue
            taxid = int(m.group(1))
            cols = _headerless_columns(f, tables.typed_column)
            spectra = _frame_values([c.astype(float) for c in cols[:nchan]],
                                    len(cols[0]))
            stats[(enc_set, taxid)] = (spectra.mean(axis=0),
                                       spectra.std(axis=0))
            if taxid not in taxa_seen:
                taxa_seen.append(taxid)

    if taxon_order is None:
        ordered = [t for t in DEFAULT_TAXON_ORDER if t in taxa_seen]
        ordered += [t for t in taxa_seen if t not in ordered]
    else:
        ordered = [t for t in taxon_order if t in taxa_seen]

    if output_pdf is not None and ordered:
        fig = plt.figure(figsize=(9 / 2.54, 7 / 2.54))
        gs = GridSpec(max(len(ordered), 2), 2 * len(encoding_sets))
        for k, enc_set in enumerate(encoding_sets):
            for i, taxid in enumerate(ordered):
                if (enc_set, taxid) not in stats:
                    continue
                avg, std = stats[(enc_set, taxid)]
                ax = plt.subplot(gs[i, 2 * k:2 * k + 2])
                for b in range(len(block_bounds) - 1):
                    lo, hi = block_bounds[b], block_bounds[b + 1]
                    ax.errorbar(np.arange(lo, hi), avg[lo:hi],
                                yerr=std[lo:hi], color=colors[b % 4],
                                fmt="-o", markersize=0.1, capsize=0.4,
                                linewidth=1.2, elinewidth=0.2,
                                capthick=0.2, markeredgewidth=0)
                ax.set_xticks([])
                ax.set_yticks([])
                if k == 0:
                    name = sci_names.get(taxid, str(taxid))
                    ax.set_ylabel(name, rotation=0,
                                  horizontalalignment="right",
                                  rotation_mode="anchor", fontsize=6,
                                  fontstyle="italic")
                if i == 0 and k < len(set_titles):
                    ax.set_title(set_titles[k], fontsize=6)
        plt.subplots_adjust(left=0.2, right=0.98, top=0.9, bottom=0.1)
        plt.savefig(output_pdf, dpi=300, transparent=True)
        plt.close(fig)
    return stats


def _distinct_taxa(probes: dict) -> dict:
    """The distinct (target_taxon, code) rows of a probe design in
    first-seen order (pandas' drop_duplicates)."""
    taxa, codes = probes["target_taxon"], probes["code"]
    seen, keep = set(), []
    for i, key in enumerate(zip(outputs.cells_as_text(taxa),
                                outputs.cells_as_text(codes))):
        if key not in seen:
            seen.add(key)
            keep.append(i)
    keep = np.array(keep, np.int64)
    return {"target_taxon": taxa[keep], "code": codes[keep]}


def summarize_multispecies_error_rate(input_folder: str,
                                      probe_design_filenames,
                                      encoding_sets=("B", "C", "A"),
                                      output_pdf: str | None = None):
    """Per-taxon error rates and Hamming-distance distributions per
    encoding set. Returns one table per encoding set ({target_taxon, code,
    ErrorRate, UpperLimit, EncodingSet}); renders the error and violin
    figure when output_pdf is set."""
    from scipy import stats as sstats

    summaries = []
    hamming_all = []
    for k, enc_set in enumerate(encoding_sets):
        filenames = sorted(
            glob.glob(os.path.join(
                input_folder, f"*_{enc_set}_*_cell_information.csv")))
        summary = _distinct_taxa(
            tables.read_probe_design(probe_design_filenames[k]))
        n = len(summary["code"])
        summary["ErrorRate"] = np.zeros(n)
        summary["UpperLimit"] = np.zeros(n, np.int64)
        hammings = {}
        for f in filenames:
            m = re.search(r"_([0-9]+)_fov_", os.path.basename(f))
            if not m:
                continue
            taxid = int(m.group(1))
            row = summary["target_taxon"] == taxid
            if not row.any():
                continue
            expected = summary["code"][row][0]
            nbits = len(expected)
            barcodes, spectra = _read_cell_information(f, nbits)
            if barcodes is None:
                continue
            max_int = spectra.max(axis=1)
            mode = sstats.mode(np.round(max_int, 3), axis=None,
                               keepdims=False).mode
            kept = barcodes[max_int > 0.75 * float(mode)]
            if kept.shape[0] == 0:
                continue
            err = 1 - np.mean(kept == expected)
            if err > 0:
                summary["ErrorRate"][row] = err
            else:
                summary["ErrorRate"][row] = 1 / kept.shape[0]
                summary["UpperLimit"][row] = 1
            hammings[taxid] = np.array(
                [hamming(str(b).split("_")[0].zfill(nbits), expected)
                 for b in kept]
            )
        summary["EncodingSet"] = np.array([enc_set] * n, dtype=object)
        summaries.append(summary)
        hamming_all.append(hammings)

    if output_pdf is not None:
        plt = _pyplot()
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(6, 5))
        colors = ["darkviolet", "dodgerblue", "orangered"]
        for k, summary in enumerate(summaries):
            n = len(summary["code"])
            ax1.plot(np.arange(n), summary["ErrorRate"], "o",
                     color=colors[k % 3], markersize=4, alpha=0.8,
                     label=summary["EncodingSet"][0] if n else "")
            data = [v for v in hamming_all[k].values() if len(v)]
            if data:
                ax2.violinplot(data, positions=np.arange(len(data)) + 1
                               + (k - 1) * 0.1, showmeans=True,
                               showextrema=False, widths=0.5)
        ax1.set_yscale("log")
        ax1.set_ylim(1e-5, 1)
        ax1.set_ylabel("Error Rate")
        ax1.legend(fontsize=7)
        ax2.set_ylabel("Hamming distance")
        fig.tight_layout()
        fig.savefig(output_pdf, dpi=300)
        plt.close(fig)
    return summaries
