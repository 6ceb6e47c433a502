"""Workflow driver CLI, the `snakemake --configfile ...` replacement (the
port of hiprfish_tpu/cli/workflow.py, same flags, plus --device):

  python -m hiprfish_tpu_torch.cli.workflow hiprfish_config_imaging.json \
      [--family ecoli|multispecies] [--max_cells N] [--device cpu]
"""

from __future__ import annotations

import argparse

from hiprfish_tpu_torch.cli import add_device_flag, resolve_device
from hiprfish_tpu_torch.utils.logging import RunLog
from hiprfish_tpu_torch.workflows import driver


def main(argv=None) -> RunLog:
    """Run the workflow; returns its RunLog (stages and summary)."""
    parser = argparse.ArgumentParser("Run a HiPR-FISH imaging workflow")
    parser.add_argument("configfile", type=str,
                        help="hiprfish_config_imaging.json")
    parser.add_argument("--family", choices=["ecoli", "multispecies"],
                        default="ecoli")
    parser.add_argument("--max_cells", type=int, default=4096)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    log = RunLog()
    if args.family == "ecoli":
        out = driver.run_ecoli_workflow(args.configfile, log,
                                        args.max_cells, device)
        print(f"results: {out}")
    else:
        driver.run_multispecies_workflow(args.configfile, log,
                                         args.max_cells, device)
    return log


if __name__ == "__main__":
    main()
