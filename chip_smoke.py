#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (hiprfish_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the script exits
non-zero and prints no result:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from csrc/ (nvcc) and print the build time;
  3. run each kernel against its plain-torch twin on the card at the main
     path's shapes (2000^2 images, the 2000^2 label image with the bf16
     (2000, 2000, 63) cube and 16384 segments, a 16384-entry table), and
     print the max error against the stated tolerance and both median times;
  4. run the port's fov_step on a 256^2 FOV on the CPU (plain versions) and
     on the card (kernels), and hold the two results together;
  5. run fov_step on the 2000^2 7-bit FOV (400 planted cells) with the
     committed 127-code classifier and max_cells=8192; every kernel's launch
     count must rise during that call; barcode accuracy against the planted
     truth must be >= 0.99 over >= 380 matched cells; print ms/FOV (median
     of 5 synchronised calls after the counted one).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. The script imports neither jax
nor the JAX package hiprfish_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# the committed 127-code classifier and the flagship step's cell capacity;
# the FOV itself is hiprfish_tpu_torch.utils.synthetic.flagship_fov
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "torch_port_clf_7b_127x50.npz")
MAX_CELLS = 8192
# kernel vs plain tolerances (absolute, on the card)
TOL = {
    # NLM: weights exp(-d2/h^2) amplify f32 rounding of the box sums by
    # 1/h^2 = 2500; the kernel sums 49 terms directly where the plain
    # version differences cumulative sums
    "nlm": 1e-5,
    "lpcv2d": 1e-6,
    # counts and border counts are exact; sums are atomics in run order,
    # within 2^-16 relative of the plain version
    "label_stats": 2.0 ** -16,
    "label_lookup": 0.0,
}
TOL_TEXT = {
    "nlm": f"tol {TOL['nlm']:.0e} abs",
    "lpcv2d": f"tol {TOL['lpcv2d']:.0e} abs",
    "label_stats": "counts exact, sums tol 2^-16 rel",
    "label_lookup": "exact",
}
REPLACES = {
    "nlm": "hiprfish_tpu/ops/nlm_pallas.py:399",
    "lpcv2d": "hiprfish_tpu/ops/lp_pallas.py:72",
    "label_stats": "hiprfish_tpu/ops/segstats_pallas.py:168",
    "label_lookup": "hiprfish_tpu/ops/segstats_pallas.py:452",
}
SOURCES = {
    "nlm": "hiprfish_tpu_torch/csrc/nlm.cu",
    "lpcv2d": "hiprfish_tpu_torch/csrc/lpcv2d.cu",
    "label_stats": "hiprfish_tpu_torch/csrc/segstats.cu",
    "label_lookup": "hiprfish_tpu_torch/csrc/segstats.cu",
}


def _time_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _agree(torch, name, out_k, out_p):
    """(max abs error, within tolerance) of a kernel's output against its
    plain twin's."""
    diff = (out_k - out_p).abs()
    err = float(diff.max())
    if name != "label_stats":
        return err, err <= TOL[name]
    # columns 0-1 are counts and border counts: exact
    rel = float((diff[:, 2:] / out_p[:, 2:].abs().clamp(min=1.0)).max())
    return err, (bool(torch.equal(out_k[:, :2], out_p[:, :2]))
                 and rel <= TOL[name])


def _barcode_accuracy(seg, truth, codes_pred, cell_codes, codebook, layout,
                      n_found: int, max_cells: int):
    """Majority-overlap match of found cells to planted cells, then the
    fraction whose called barcode is the planted one (bench.py's rule)."""
    pairs = (seg.astype(np.int64) << 32) | truth.astype(np.int64)
    vals, cnt = np.unique(pairs, return_counts=True)
    s = vals >> 32
    t = vals & 0xFFFFFFFF
    keep = (s > 0) & (s <= min(n_found, max_cells - 1)) & (t > 0)
    s, t, cnt = s[keep], t[keep], cnt[keep]
    order = np.argsort(cnt, kind="stable")
    majority = {}
    for si, ti in zip(s[order], t[order]):
        majority[int(si)] = int(ti)        # ascending counts: last wins
    correct = sum(codebook[codes_pred[lab]] ==
                  layout.code_str(cell_codes[tid - 1])
                  for lab, tid in majority.items())
    return correct, len(majority)


def _smooth_image(shape, seed: int):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(yy / 17.0) * np.cos(xx / 23.0) \
        + 0.005 * rng.randn(*shape)
    return img.astype(np.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1

    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.kernels import _build
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.ops import denoise, line_profile, segstats
    from hiprfish_tpu_torch.pipeline import fused
    from hiprfish_tpu_torch.utils import synthetic

    # 1. the card
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")

    # 2. build
    t0 = time.time()
    lib = _build.build()
    _build.load()
    print(f"phase 2 build: {time.time() - t0:.1f} s -> {lib}")

    # 3. kernels vs plain at the main path's shapes
    layout = SEVEN_BIT
    cell_codes = synthetic.FLAGSHIP_CODES
    size = synthetic.FLAGSHIP_SHAPE[0]
    t0 = time.time()
    fov = synthetic.flagship_fov()
    print(f"phase 3 fixture: {size}^2 x {layout.n_channels} ch, "
          f"{len(cell_codes)} cells, built in {time.time() - t0:.1f} s")
    report = {}

    def check(name, kernel, plain, reps, plain_reps):
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = _agree(torch, name, out_k, out_p)
        ms = _time_ms(torch, kernel, reps)
        plain_ms = _time_ms(torch, plain, plain_reps)
        print(f"phase 3 {name}: max_abs_err {err:.3e} ({TOL_TEXT[name]}) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with plain")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        return out_k

    smooth = torch.from_numpy(_smooth_image((size, size), 0)).to(dev)
    den = check("nlm", lambda: kernels.nlm(smooth, 0.02, 7, 11),
                lambda: denoise.denoise_nl_means_plain(smooth, 0.02, 7, 11),
                5, 3)
    check("lpcv2d", lambda: kernels.lpcv2d(den),
          lambda: line_profile.lp_cv_enhance_2d_plain(den, 11, 9), 10, 5)

    labels = torch.from_numpy(fov["truth_labels"].astype(np.int32)).to(dev)
    flat = labels.reshape(-1)
    cube_flat = torch.cat([torch.from_numpy(a) for a in fov["stack"]], dim=2) \
        .to(dev).to(torch.bfloat16).reshape(flat.shape[0], -1)
    nseg = 2 * MAX_CELLS
    stats_args = (flat, cube_flat, None, None, nseg, 0, False, size, size)
    check("label_stats", lambda: kernels.label_stats(*stats_args),
          lambda: segstats.label_stats_table_plain(*stats_args), 10, 5)

    gen = torch.Generator(device="cpu").manual_seed(0)
    tbl = torch.rand(nseg, generator=gen).to(dev)
    check("label_lookup", lambda: kernels.label_lookup(labels, tbl),
          lambda: segstats.label_lookup_plain(labels, tbl), 20, 20)

    # 4. a small FOV: plain versions on the CPU vs kernels on the card
    cfg = SegmentationConfig()
    clf = load_classifier(FIXTURE)
    small = synthetic.make_fov(layout, [1 + (i * 7) % 127 for i in range(30)],
                               shape=(256, 256), seed=1,
                               laser_shifts=synthetic.FLAGSHIP_SHIFTS,
                               cell_axes=synthetic.FLAGSHIP_CELL_AXES)
    outs = []
    for d in (torch.device("cpu"), dev):
        arr, static = fused.classifier_from_numpy(clf, d)
        st = tuple(torch.from_numpy(a).to(d) for a in small["stack"])
        outs.append(fused.fov_step(st, arr, cfg, 64, static))
    cpu_r, gpu_r = outs
    n_c, n_g = int(cpu_r.n_cells), int(gpu_r.n_cells)
    seg_agree = float((cpu_r.segmentation
                       == gpu_r.segmentation.cpu()).float().mean())
    v = cpu_r.valid
    codes_eq = bool(torch.equal(cpu_r.code_idx[v], gpu_r.code_idx.cpu()[v]))
    print(f"phase 4 256^2 cpu vs gpu: n_cells {n_c} / {n_g}, segmentation "
          f"agreement {seg_agree:.6f}, code_idx equal {codes_eq}")
    if n_c != n_g or not codes_eq or seg_agree < 0.999:
        raise AssertionError("256^2 FOV: the card disagrees with the CPU")

    # 5. the main path at full size
    arrays, static = fused.classifier_from_numpy(clf, dev)
    stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
    torch.cuda.synchronize()
    step = lambda: fused.fov_step(stack, arrays, cfg, MAX_CELLS,  # noqa
                                  static)
    kernels.reset_launches()
    t0 = time.time()
    res = step()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = kernels.launch_counts()
    print(f"phase 5 first call {first_s:.2f} s, launches {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by fov_step: {missing}")
    seg = res.segmentation.cpu().numpy()
    n_found = int(res.n_cells)
    if seg.shape != (size, size) or not bool(torch.isfinite(
            res.avgint).all()):
        raise AssertionError("fov_step output malformed")
    correct, total = _barcode_accuracy(
        seg, fov["truth_labels"], res.code_idx.cpu().numpy(), cell_codes,
        list(clf.codebook), layout, n_found, MAX_CELLS)
    acc = correct / max(total, 1)
    times = []
    for _ in range(5):
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1000)
    ms = float(np.median(times))
    print(f"phase 5 fov_step {size}^2: n_cells {n_found}, matched {total}, "
          f"accuracy {acc:.4f} ({correct}/{total}), {ms:.1f} ms/FOV "
          f"(median of 5; all {[round(t, 1) for t in times]})")
    if total < 380 or acc < 0.99:
        raise AssertionError("accuracy below 0.99 or fewer than 380 cells")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k], **report[k]}
        for k in ("nlm", "lpcv2d", "label_stats", "label_lookup")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
