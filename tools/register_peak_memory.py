"""Peak device memory of the volumetric analysis' registration on one
microscope tile, for the package in this checkout or in another one.

    python tools/register_peak_memory.py [--root DIR] [--z Z ...] [--out PATH]

Imports hiprfish_tpu_torch from ``--root`` (default: this checkout; give
an unpacked copy of another commit to compare the two on one card), makes
the per-laser (Z, X, Y, C_l) float32 stacks of chip_smoke.py's phase 16c
tile (VolumeSpec((1040, 550, Z), (36, 36, 52), seed 5), lasers 2-4 rolled
by chip_smoke.VOLUME_ROLLS; chip_smoke._fill_tile_stacks of this
checkout) in host memory for each ``--z`` (default 110 and 170), and
registers them as the package's volumetric front end does: a
register_volume_stack that takes a ``device`` gets the host stacks as a
list and moves them itself; an older one gets all four volumes on the card
first, as the older z-stack front end handed them over. Prints, per Z,
the shifts, the seconds and torch.cuda.max_memory_allocated() from just
before the call (the older composition's inputs included), with the
card's name and power limit, and writes them as one JSON object to
``--out`` (default build/register_peak_memory[_<root name>].json).
Needs a CUDA device; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--z", type=int, nargs="*", default=[110, 170])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, ROOT)
    from chip_smoke import _fill_tile_stacks

    sys.path.insert(0, root)
    import torch

    from hiprfish_tpu_torch.config import SEVEN_BIT
    from hiprfish_tpu_torch.pipeline import segment3d
    from hiprfish_tpu_torch.utils import synthetic, synthetic3d

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"package: {os.path.dirname(segment3d.__file__)}")
    dev = torch.device("cuda", 0)
    takes_device = "device" in inspect.signature(
        segment3d.register_volume_stack).parameters
    lut = np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                    for c in range(1, 128)]).astype(np.float32)
    lut_dev = torch.from_numpy(lut).to(dev)
    result = {"card": card, "root": root, "takes_device": takes_device,
              "runs": []}
    for z in args.z:
        spec = synthetic3d.VolumeSpec(shape=(1040, 550, z),
                                      spacing=(36, 36, 52), seed=5)
        stacks = [np.empty((z, 1040, 550, hi - lo), np.float32)
                  for lo, hi in SEVEN_BIT.blocks]
        _fill_tile_stacks(torch, spec, lut_dev, stacks)
        host = [np.moveaxis(a, 0, 2) for a in stacks]
        del stacks
        if takes_device:
            volumes = host
        else:
            volumes = [torch.from_numpy(np.moveaxis(a, 2, 0)).to(dev)
                       .permute(1, 2, 0, 3).contiguous() for a in host]
        del host
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        run = {"shape": list(spec.shape)}
        try:
            if takes_device:
                shifts = []
                cube = segment3d.register_volume_stack(volumes, dev, shifts)
            else:
                cube = segment3d.register_volume_stack(volumes)
                shifts = None
            torch.cuda.synchronize()
            run.update(seconds=time.time() - t0, shifts=shifts,
                       cube_gib=cube.numel() * 4 / 2**30)
            del cube
        except torch.cuda.OutOfMemoryError as e:
            run["error"] = f"out of memory: {str(e).splitlines()[0]}"
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del volumes
        torch.cuda.empty_cache()
        print(json.dumps(run))
        result["runs"].append(run)
    out = args.out or os.path.join(
        ROOT, "build", "register_peak_memory"
        + ("" if root == ROOT else "_" + os.path.basename(root)) + ".json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
