"""Titration-experiment summary CLI (the port of
hiprfish_tpu/cli/summarize_titration.py, same flags).

-m selects the mix ids; abundance files are globbed as
images_table_mix_<m>_results_abundance.csv in the data directory. Writes
titration_mix_<m>.pdf (or titration_all.pdf) and prints the regression.
Needs matplotlib for the figure.
"""

from __future__ import annotations

import argparse
import os

from hiprfish_tpu_torch.pipeline import summarize


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Summarize HiPR-FISH titration experiments")
    parser.add_argument("data_dir", type=str)
    parser.add_argument("-m", "--mix", dest="mix", nargs="*", default=None,
                        help="Mix ids (default: all)")
    args = parser.parse_args(argv)
    if args.mix:
        for m in args.mix:
            g = os.path.join(args.data_dir,
                             f"images_table_mix_{m}_results_abundance.csv")
            res = summarize.plot_titration_correlation(
                g, os.path.join(args.data_dir, f"titration_mix_{m}.pdf"))
            if res:
                print(f"mix {m}: slope={res['slope']:.4g} "
                      f"r={res['rvalue']:.4f} "
                      f"gross_error={res['gross_error_rate']:.4g}")
    else:
        g = os.path.join(args.data_dir,
                         "images_table_mix_*_results_abundance.csv")
        res = summarize.plot_titration_correlation(
            g, os.path.join(args.data_dir, "titration_all.pdf"))
        if res:
            print(f"all mixes: slope={res['slope']:.4g} "
                  f"r={res['rvalue']:.4f} "
                  f"gross_error={res['gross_error_rate']:.4g}")


if __name__ == "__main__":
    main()
