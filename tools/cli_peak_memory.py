"""Peak device memory of the 7-bit measure command lines on the 2000^2 FOV,
for the package in this checkout or in another one.

    python tools/cli_peak_memory.py [--root DIR] [--out PATH]

Imports hiprfish_tpu_torch from ``--root`` (default: this checkout; give
an unpacked copy of another commit to compare the two on one card), saves
chip_smoke.py's 2000^2 7-bit FOV (hiprfish_tpu_torch.utils.synthetic.
flagship_fov) as four .npy planes in a temporary directory and runs, twice
each (cold, warm), cli.measure_multispecies at its default flags and, where
the package has it, cli.biofilm -d 2 with a probe design of the committed
127-code classifier's codes. Prints, per call, its wall seconds and
torch.cuda.max_memory_allocated() from the call's start, with the card's
name and power limit, and writes them as one JSON object to ``--out``
(default chiprun_out/cli_peak_memory[_<root name>].json). Needs a CUDA
device; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LASERS_7B = ("488", "514", "561", "633")
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_clf_7b_127x50.npz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import importlib.util

    import torch

    from hiprfish_tpu_torch.cli import measure_multispecies as cli_ms
    from hiprfish_tpu_torch.utils import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"package: {os.path.dirname(cli_ms.__file__)}")
    has_biofilm = importlib.util.find_spec(
        "hiprfish_tpu_torch.cli.biofilm") is not None
    fov = synthetic.flagship_fov()
    result = {"card": card, "root": root, "calls": []}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            names = [f"flagship_{laser}.npy" for laser in LASERS_7B]
            for name, plane in zip(names, fov["stack"]):
                np.save(name, plane)
            del fov
            runs = [("cli.measure_multispecies",
                     lambda: cli_ms.main(["-i", *names]))]
            if has_biofilm:
                from hiprfish_tpu_torch.cli import biofilm as cli_biofilm
                from hiprfish_tpu_torch.models import artifacts

                os.mkdir("fov")
                for name in names:
                    os.link(name, os.path.join("fov", name))
                with open("probes.csv", "w") as f:
                    f.write("target_taxon,code\n")
                    f.writelines(f"{1000 + i},{c}\n" for i, c in enumerate(
                        artifacts.load_classifier(FIXTURE).codebook))
                runs.append(("cli.biofilm -d 2", lambda: cli_biofilm.main(
                    ["fov", "-p", "probes.csv", "-r", FIXTURE, "-d", "2"])))
            for name, call in runs:
                for turn in ("cold", "warm"):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.time()
                    call()
                    torch.cuda.synchronize()
                    wall = time.time() - t0
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    print(f"{name} {turn}: {wall:.2f} s, peak {peak:.3f} GiB "
                          f"({card})")
                    result["calls"].append({"cli": name, "turn": turn,
                                            "seconds": wall,
                                            "peak_gib": peak})
        finally:
            os.chdir(cwd)
    tag = "" if root == ROOT else "_" + os.path.basename(root)
    out = args.out or os.path.join(ROOT, "chiprun_out",
                                   f"cli_peak_memory{tag}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
