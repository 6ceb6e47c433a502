"""Result collection CLI (the port of hiprfish_tpu/cli/collect.py, same
flags): positional data_dir, simulation_table, simulation_results;
-t R (reference error rates) | M (mix abundance)."""

from __future__ import annotations

import argparse

from hiprfish_tpu_torch.pipeline import collect


def main(argv=None):
    parser = argparse.ArgumentParser("Collect HiPR-FISH measurement results")
    parser.add_argument("data_dir", type=str)
    parser.add_argument("simulation_table", type=str)
    parser.add_argument("simulation_results", type=str)
    parser.add_argument("-t", "--type", dest="type", type=str, default="R")
    args = parser.parse_args(argv)
    if args.type == "R":
        collect.collect_reference_measurement_results(
            args.data_dir, args.simulation_table, args.simulation_results)
    else:
        collect.collect_mix_measurement_results(
            args.data_dir, args.simulation_table, args.simulation_results)


if __name__ == "__main__":
    main()
