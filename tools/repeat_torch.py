"""Run the port's paths many times on one input each and hold every call
to the first.

    python tools/repeat_torch.py [--fov7-calls 20] [--ecoli-calls 40] \\
        [--host-calls 20] [--volume-passes 3] [--out PATH]

Modes (a count of 0 skips one):

  * ``--fov7-calls``: fused.fov_step on chip_smoke.py's 2000^2 7-bit FOV
    (hiprfish_tpu_torch.utils.synthetic.flagship_fov, the committed
    127-code classifier, max_cells 8192);
  * ``--ecoli-calls``: fused_ecoli.fov_step_ecoli on the 2000^2 10-bit FOV
    (synthetic.ecoli_fov, the committed 1023-class classifier);
  * ``--host-calls``: the 10-bit host engine segment2d.segment_ecoli on the
    same FOV (its labels only);
  * ``--volume-passes``: the 3D volume pass of chip_smoke.py phase 8
    (stitch -> segment_3d_tiled -> streamed measurement -> classify) on
    the 2020 x 2020 x 170 fixture, each pass from its own copy of the same
    microscope tiles.

For each mode it prints n_cells over the calls and in how many calls the
labels (bitwise) and the per-cell calls equal the first call's. Every
per-cell sum that decides a cell's fate is exact (B3's integer columns)
and the KMeans bin sums are order-free, so nothing may move; the channel
sums (B3, B5) still add in the card's atomic order, so a call could flip
only for a cell whose spectrum sits on a decision boundary. Writes one
JSON object with the card's name and power limit to ``--out`` (default
build/repeat_torch.json); exits 2 when n_cells, the labels or the calls of
any call differ from its mode's first call. Needs a CUDA device; imports
neither jax nor the JAX package.
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


def _repeat(torch, name, calls, step, keys):
    """Call ``step()`` ``calls`` times; each returns (n_cells, {key:
    tensor}). Returns the mode's record and prints its line."""
    first = None
    n_cells, same, ms = [], [], []
    for _ in range(calls):
        t0 = time.time()
        n, out = step()
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1000)
        n_cells.append(n)
        if first is None:
            first = out
        same.append(all(torch.equal(out[k], first[k]) for k in keys))
    print(f"{name}: n_cells over {calls} calls "
          f"{ {n: n_cells.count(n) for n in sorted(set(n_cells))} }; labels"
          f"{' and calls' if len(keys) > 1 else ''} equal to the first "
          f"call's in {sum(same)}/{calls}")
    return {"calls": calls, "n_cells": n_cells, "equal_to_first": same,
            "ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fov7-calls", type=int, default=20)
    ap.add_argument("--ecoli-calls", type=int, default=40)
    ap.add_argument("--host-calls", type=int, default=20)
    ap.add_argument("--volume-passes", type=int, default=3)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "repeat_torch.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("repeat_torch: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import chip_smoke
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused, fused_ecoli, segment2d
    from hiprfish_tpu_torch.utils import synthetic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    cfg = SegmentationConfig()
    result = {"device": smi}

    def fov_mode(name, calls, fov, fixture, step_fn):
        clf = load_classifier(fixture)
        arrays, static = fused.classifier_from_numpy(clf, dev)
        stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])

        def step():
            r = step_fn(stack, arrays, cfg, chip_smoke.MAX_CELLS, static)
            return int(r.n_cells), {"labels": r.segmentation,
                                    "calls": r.code_idx}
        result[name] = _repeat(torch, name, calls, step,
                               ("labels", "calls"))

    if args.fov7_calls:
        fov_mode("fov_step", args.fov7_calls, synthetic.flagship_fov(),
                 chip_smoke.FIXTURE, fused.fov_step)
    if args.ecoli_calls or args.host_calls:
        efov = synthetic.ecoli_fov()
        if args.ecoli_calls:
            fov_mode("fov_step_ecoli", args.ecoli_calls, efov,
                     chip_smoke.FIXTURE_10B, fused_ecoli.fov_step_ecoli)
        if args.host_calls:
            estack = tuple(torch.from_numpy(a).to(dev)
                           for a in efov["stack"])

            def host_step():
                seg = segment2d.segment_ecoli(estack, cfg,
                                              chip_smoke.MAX_CELLS)
                return int(seg.n_cells), {"labels": seg.segmentation}
            result["segment_ecoli"] = _repeat(
                torch, "segment_ecoli", args.host_calls, host_step,
                ("labels",))
        del efov
    if args.volume_passes:
        from hiprfish_tpu_torch.utils import synthetic3d as s3

        spec = s3.VolumeSpec(shape=chip_smoke.SHAPE_3D, spacing=(36, 36, 52),
                             seed=5)
        lut = np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                        for c in range(1, 128)]).astype(np.float32)
        lut_dev = torch.from_numpy(lut).to(dev)
        clf = load_classifier(chip_smoke.FIXTURE)
        arrays, static = fused.classifier_from_numpy(clf, dev)
        tiles = chip_smoke._volume_tiles(torch, dev, spec, lut_dev)

        def volume_step():
            box = [[t.clone() for t in tiles]]
            r = chip_smoke._volume_step(
                torch, box, spec, lut_dev, arrays, static, cfg,
                chip_smoke.TILED_3D, chip_smoke.MAX_CELLS_3D)
            return int(r["n_cells"]), {
                "labels": r["seg_xzy"],
                "calls": torch.from_numpy(r["pred"])}
        result["volume_3d"] = _repeat(torch, "volume_3d", args.volume_passes,
                                      volume_step, ("labels", "calls"))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    modes = [v for k, v in result.items() if k != "device"]
    stable = all(len(set(m["n_cells"])) == 1 and all(m["equal_to_first"])
                 for m in modes)
    return 0 if stable else 2


if __name__ == "__main__":
    sys.exit(main())
