"""Where the time of the port's 7-bit fov_step goes, on one GPU.

    python tools/profile_torch_fov.py [--out PATH]

Runs hiprfish_tpu_torch.pipeline.fused.fov_step on the 2000^2 7-bit FOV
(400 planted cells, the committed 127-code classifier, max_cells=8192)
and reports:

  * per-stage time: every op the step calls is wrapped so that it
    synchronises the card before and after itself; the host clock between
    the two syncs is the stage's time (the syncs serialise the step, so the
    stages add up to more than an unwrapped call);
  * the unwrapped step's wall time (median of 5) and, from one
    torch.profiler trace, the device time per kernel name and the device's
    idle share (1 - summed kernel time / wall time, against the profiled
    call's wall and against the unprofiled median).

The FOV, classifier and cell capacity are chip_smoke.py's. Needs a CUDA
device; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "profile_torch_fov.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_fov: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import FIXTURE, MAX_CELLS
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused
    from hiprfish_tpu_torch.utils import synthetic

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fov = synthetic.flagship_fov()
    clf = load_classifier(FIXTURE)
    arrays, static = fused.classifier_from_numpy(clf, dev)
    stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
    cfg = SegmentationConfig()

    def step():
        return fused.fov_step(stack, arrays, cfg, MAX_CELLS, static)

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))

    # per-stage times: wrap the ops fused.py calls, syncing around each
    stage_ms = collections.defaultdict(float)
    stage_calls = collections.Counter()
    wrapped = []

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_ms[label] += (time.perf_counter() - t0) * 1e3
            stage_calls[label] += 1
            return out

        setattr(mod, name, timed)
        wrapped.append((mod, name, fn))

    stages = [
        (fused.reg, "register_translation", "register: FFT shift"),
        (fused.reg, "apply_shift_2d", "register: apply shift"),
        (fused.dn, "denoise_nl_means", "NLM (kernel B1)"),
        (fused.lp, "lp_cv_enhance_2d", "LP-CV (kernel B2)"),
        (fused.km, "brightest_cluster_mask", "KMeans"),
        (fused.morph, "binary_opening", "opening"),
        (fused.morph, "binary_fill_holes", "fill holes"),
        (fused.lab, "label", "CCL"),
        (fused.segstats, "rank_labels", "rank"),
        (fused.segstats, "label_stats", "label stats (kernel B3)"),
        (fused.segstats, "label_lookup", "label lookup (kernel B4)"),
        (fused.ws, "watershed", "watershed"),
        (fused, "classify_capped", "classify"),
    ]
    for mod, name, label in stages:
        wrap(mod, name, label)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        synced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in wrapped:
            setattr(mod, name, fn)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if dt and ev.device_type.name == "CUDA":
            rows.append((ev.key, dt / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)

    result = {
        "card": card,
        "wall_ms_median5": wall_ms,
        "wall_ms_all": walls,
        "synced_stages_total_ms": synced_ms,
        "stages_ms": dict(sorted(stage_ms.items(), key=lambda kv: -kv[1])),
        "stage_calls": dict(stage_calls),
        "profiled_wall_ms": prof_wall_ms,
        "device_kernel_ms": device_ms,
        # the profiler slows the host, so the profiled call's idle share is
        # an upper bound; against the unprofiled median wall, a lower one
        "device_idle_share": (1.0 - device_ms / prof_wall_ms
                              if prof_wall_ms else None),
        "device_idle_share_vs_unprofiled_wall": 1.0 - device_ms / wall_ms,
        "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                        for n, ms, c in rows[:25]],
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"card: {card}")
    print(f"fov_step wall {wall_ms:.1f} ms (median of 5); with per-stage "
          f"syncs {synced_ms:.1f} ms")
    for k, v in result["stages_ms"].items():
        print(f"  {k:28s} {v:8.2f} ms  x{stage_calls[k]}")
    print(f"profiled call: wall {prof_wall_ms:.1f} ms, kernels "
          f"{device_ms:.1f} ms, idle share "
          f"{result['device_idle_share']:.3f} (vs the unprofiled wall "
          f"{result['device_idle_share_vs_unprofiled_wall']:.3f})")
    for r in result["top_kernels"][:12]:
        print(f"  {r['ms']:8.2f} ms x{r['count']:5d}  {r['name']}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
