"""Multispecies analysis CLI (the port of
hiprfish_tpu/cli/analyze_multispecies.py, same flags): per-taxon error
rates of each encoding set (multispecies_error_rate.pdf), the per-taxon
spectra grid (multispecies_representative_cell_spectra.pdf), and each
encoding set's table printed as plain columns. Needs matplotlib."""

from __future__ import annotations

import argparse
import os

from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.pipeline import summarize


def format_table(table: dict) -> str:
    """A table as right-aligned plain-text columns under a header line,
    each cell as the CSV writers write it."""
    cells = [[name, *outputs.cells_as_text(col)]
             for name, col in table.items()]
    widths = [max(len(c) for c in col) for col in cells]
    return "\n".join(
        "  ".join(col[i].rjust(w) for col, w in zip(cells, widths))
        for i in range(len(cells[0])))


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Summarize multispecies synthetic community measurement results")
    parser.add_argument("input_folder", type=str)
    parser.add_argument("-p", "--probe_design_filename",
                        dest="probe_design_filename", type=str, nargs="*",
                        help="Probe design filenames (one per encoding set)")
    args = parser.parse_args(argv)
    summaries = summarize.summarize_multispecies_error_rate(
        args.input_folder, args.probe_design_filename,
        output_pdf=os.path.join(args.input_folder,
                                "multispecies_error_rate.pdf"))
    summarize.plot_representative_cell_spectra(
        args.input_folder,
        output_pdf=os.path.join(
            args.input_folder, "multispecies_representative_cell_spectra.pdf"))
    for s in summaries:
        if len(s["code"]):
            print(format_table(s))
    return summaries


if __name__ == "__main__":
    main()
