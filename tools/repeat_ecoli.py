"""Run the 10-bit E. coli engines many times on one FOV and report n_cells.

    python tools/repeat_ecoli.py [--calls 40] [--host-calls 20] [--out PATH]

Builds the 2000^2 10-bit FOV of chip_smoke.py (hiprfish_tpu_torch.utils.
synthetic.ecoli_fov) and the committed 1023-class classifier, then calls
fused_ecoli.fov_step_ecoli ``--calls`` times and the host engine
segment2d.segment_ecoli ``--host-calls`` times (max_cells 8192), and
prints each engine's n_cells and in how many calls its segmentation (and,
for the fused step, its calls) is bitwise equal to the first call's. Every
per-cell sum that decides a cell's fate (count, border, moments,
eroded-mask count) is exact, so the cells found must not change between
calls; the KMeans histogram and the channel sums still add in the card's
atomic order, so this counts how often anything moves. Writes one JSON
object to ``--out`` (default build/repeat_ecoli.json) with the card's name
and power limit; exits 2 when n_cells varies. Needs a CUDA device;
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--host-calls", type=int, default=20)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "repeat_ecoli.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("repeat_ecoli: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import chip_smoke
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused, fused_ecoli, segment2d
    from hiprfish_tpu_torch.utils import synthetic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    fov = synthetic.ecoli_fov()
    clf = load_classifier(chip_smoke.FIXTURE_10B)
    arrays, static = fused.classifier_from_numpy(clf, dev)
    stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
    cfg = SegmentationConfig()
    first = None
    n_cells, same, ms = [], [], []
    for _ in range(args.calls):
        t0 = time.time()
        res = fused_ecoli.fov_step_ecoli(stack, arrays, cfg,
                                         chip_smoke.MAX_CELLS, static)
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1000)
        n_cells.append(int(res.n_cells))
        if first is None:
            first = res
        same.append(bool(torch.equal(res.segmentation, first.segmentation))
                    and bool(torch.equal(res.code_idx, first.code_idx)))
    host_first = None
    host_n, host_same = [], []
    for _ in range(args.host_calls):
        seg = segment2d.segment_ecoli(stack, cfg, chip_smoke.MAX_CELLS)
        host_n.append(int(seg.n_cells))
        if host_first is None:
            host_first = seg.segmentation
        host_same.append(bool(torch.equal(seg.segmentation, host_first)))
    result = {"device": smi, "calls": args.calls, "n_cells": n_cells,
              "equal_to_first": same, "ms": ms,
              "host_calls": args.host_calls, "host_n_cells": host_n,
              "host_equal_to_first": host_same}
    for name, ns, eq in (("fov_step_ecoli", n_cells, same),
                         ("segment_ecoli", host_n, host_same)):
        print(f"{name}: n_cells over {len(ns)} calls "
              f"{ {n: ns.count(n) for n in sorted(set(ns))} }; equal to the "
              f"first call's in {sum(eq)}/{len(ns)}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    return 0 if len(set(n_cells)) <= 1 and len(set(host_n)) <= 1 else 2


if __name__ == "__main__":
    sys.exit(main())
