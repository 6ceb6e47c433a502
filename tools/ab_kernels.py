"""Time two builds of kernels B1 (NLM) and B6 (3D LP-CV) in turns on one GPU.

    git archive <commit> hiprfish_tpu_torch/csrc | tar -x -C build/ab_old
    python tools/ab_kernels.py --old build/ab_old/hiprfish_tpu_torch/csrc \\
        [--out PATH]

Builds the package's ``csrc/`` and the older copy named by ``--old`` (each
into its own hashed directory under build/torch_kernels/, the two builds
in parallel) and prints ptxas's registers and spills of ``nlm.cu`` and
``lpcv3d.cu`` for both. Then, at the main paths' shapes:

  * B1 on chip_smoke.py's 2000^2 smooth image (h 0.02, patch 7, pd 11);
  * B6 in bf16 mode on the 256 x 170 x 256 (X, Z, Y) sub-volume and on the
    whole normalised 2020 x 170 x 2020 volume of chip_smoke.py phase 6;

it holds the two builds' outputs together (B1 within 1e-5, B6 within 1e-6
absolute, the kernels' tolerances against their plain twins) and times
each kernel in turns, old, new, new, old: each turn the median of CUDA
event times over its launches, after one warm launch. It prints one JSON
object with the card's name and power limit and every turn's time, and
writes it to ``--out`` (default build/ab_kernels.json). Needs a CUDA
device; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _build_both(_build, old: Path):
    """(new library path, old library path), built in parallel."""
    paths, errors = {}, []

    def run(key, csrc):
        try:
            paths[key] = _build.build(csrc)
        except Exception as e:  # reported below, after both finish
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k, c))
               for k, c in (("new", _build.CSRC), ("old", old))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return paths["new"], paths["old"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the older nlm.cu, lpcv3d.cu and "
                         "the rest of that csrc/")
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "ab_kernels.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import chip_smoke
    from hiprfish_tpu_torch.config import SEVEN_BIT
    from hiprfish_tpu_torch.kernels import _build
    from hiprfish_tpu_torch.utils import synthetic, synthetic3d as s3

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    old_dir = args.old.resolve()
    new_path, old_path = _build_both(_build, old_dir)
    libs = {"new": _build.open_library(new_path),
            "old": _build.open_library(old_path)}
    ptxas = {}
    for key, csrc in (("new", _build.CSRC), ("old", old_dir)):
        for stem in ("nlm", "lpcv3d"):
            ptxas[f"{key} {stem}"] = _build.ptxas_report(stem, csrc)
            for line in ptxas[f"{key} {stem}"]:
                print(f"ptxas {key} {stem}.cu: {line}")

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def nlm(lib, img, out):
        h2 = float(np.float32(0.02 * 0.02))
        _build.check(lib, lib.hf_nlm_f32(img.data_ptr(), out.data_ptr(),
                                         *img.shape, 11, 7, h2, stream),
                     "nlm")

    def lpcv3d(lib, vol, out):
        _build.check(lib, lib.hf_lpcv3d(vol.data_ptr(), out.data_ptr(),
                                        *vol.shape, 11, 9, 9, 1, stream),
                     "lpcv3d")

    size = synthetic.FLAGSHIP_SHAPE[0]
    img = torch.from_numpy(chip_smoke._smooth_image((size, size), 0)).to(dev)
    spec = s3.VolumeSpec(shape=chip_smoke.SHAPE_3D, spacing=(36, 36, 52),
                         seed=5)
    lut = np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                    for c in range(1, 128)]).astype(np.float32)
    vol = s3.build_sum_volume(spec, 127, lut.sum(axis=1), seed=1,
                              z_chunk=16, device=dev)
    vol_xzy = (vol / vol.max()).permute(0, 2, 1).contiguous()
    del vol
    sub = vol_xzy[:256, :, :256].contiguous()
    cases = [("nlm 2000^2", nlm, img, 1e-5, 10),
             ("lpcv3d 256x170x256", lpcv3d, sub, 1e-6, 10),
             ("lpcv3d 2020x170x2020", lpcv3d, vol_xzy, 1e-6, 3)]
    result = {"device": smi, "ptxas": ptxas, "cases": {}}
    for name, fn, x, tol, reps in cases:
        outs = {k: torch.empty_like(x) for k in libs}
        for k, lib in libs.items():
            fn(lib, x, outs[k])
        torch.cuda.synchronize()
        err = float((outs["new"] - outs["old"]).abs().max())
        turns = []
        for k in ("old", "new", "new", "old"):
            ms = chip_smoke._time_ms(
                torch, lambda: fn(libs[k], x, outs[k]), reps)
            turns.append([k, ms])
        old_ms = [ms for k, ms in turns if k == "old"]
        new_ms = [ms for k, ms in turns if k == "new"]
        print(f"{name}: new vs old max_abs_err {err:.3e} (tol {tol:.0e}); "
              f"turns (ms) " + ", ".join(f"{k} {ms:.3f}" for k, ms in turns)
              + f"; speed-up {np.mean(old_ms) / np.mean(new_ms):.2f}x")
        result["cases"][name] = {"max_abs_err": err, "turns": turns}
        if not err <= tol:
            raise AssertionError(f"{name}: the two builds disagree")
        del outs
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
