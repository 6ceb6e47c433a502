"""Classifier training CLI (the port of hiprfish_tpu/cli/train.py: the
same variants and flags, plus --device):

  python -m hiprfish_tpu_torch.cli.train <reference_folder> \
      -v violet_derivative -s 2000 [-p probe_design.csv] [-t mix_table.csv]
"""

from __future__ import annotations

import argparse

from hiprfish_tpu_torch.cli import add_device_flag, resolve_device
from hiprfish_tpu_torch.models import train as mtrain

VARIANTS = {
    "normalized": lambda a, d: mtrain.train_simulate_normalized(
        a.reference_folder, a.spc, seed=a.seed, device=d),
    "normalized_umap": lambda a, d:
        mtrain.train_simulate_normalized_umap_transformed(
            a.reference_folder, a.spc, seed=a.seed, device=d),
    "excitation_adjusted": lambda a, d: mtrain.train_excitation_adjusted(
        a.reference_folder, a.spc, seed=a.seed, device=d),
    "violet_derivative": lambda a, d:
        mtrain.train_excitation_adjusted_violet_derivative(
            a.reference_folder, a.spc, seed=a.seed, device=d),
    "biofilm_7b": lambda a, d: mtrain.train_excitation_adjusted_biofilm_7b(
        a.reference_folder, a.spc, seed=a.seed, device=d),
    "fret_biofilm_7b": lambda a, d: mtrain.train_fret_biofilm_7b(
        a.reference_folder, spc=a.spc, seed=a.seed,
        probe_design_filename=a.probe_design or None, device=d),
    "select": lambda a, d: mtrain.train_simulate_normalized_select(
        a.reference_folder, a.spc, a.input_tab, seed=a.seed, device=d),
    "direct": lambda a, d: mtrain.train_direct(a.reference_folder,
                                               seed=a.seed, device=d),
}


def main(argv=None):
    parser = argparse.ArgumentParser("Train HiPR-FISH spectral classifiers")
    parser.add_argument("reference_folder", type=str)
    parser.add_argument("-v", "--variant", default="violet_derivative",
                        choices=sorted(VARIANTS))
    parser.add_argument("-s", "--spc", type=int, default=2000,
                        help="simulations per code")
    parser.add_argument("-p", "--probe_design", type=str, default="")
    parser.add_argument("-t", "--input_tab", type=str, default="")
    parser.add_argument("--seed", type=int, default=0)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    clf = VARIANTS[args.variant](args, resolve_device(args.device))
    print(f"trained {args.variant}: {len(clf.codebook)} codes, "
          f"{clf.train_features.shape[0]} reference rows")


if __name__ == "__main__":
    main()
