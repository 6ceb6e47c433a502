"""Mix-experiment summary CLI (the port of
hiprfish_tpu/cli/summarize_mix.py, same flags): the mean-abundance figures
<abundance>_barcodes.pdf and <abundance>_distribution.pdf of a
*_results_abundance.csv. Needs matplotlib."""

from __future__ import annotations

import argparse
import re

from hiprfish_tpu_torch.pipeline import summarize


def main(argv=None):
    parser = argparse.ArgumentParser("Summarize HiPR-FISH mix experiments")
    parser.add_argument("abundance_csv", type=str,
                        help="*_results_abundance.csv from cli.collect")
    parser.add_argument("-n", "--n_barcodes", type=int, default=1023)
    args = parser.parse_args(argv)
    base = re.sub(r"\.csv$", "", args.abundance_csv)
    summarize.plot_mean_abundance_barcodes(
        args.abundance_csv, base + "_barcodes.pdf", args.n_barcodes)
    summarize.plot_mean_abundance_distribution(
        args.abundance_csv, base + "_distribution.pdf", args.n_barcodes)


if __name__ == "__main__":
    main()
