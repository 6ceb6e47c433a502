"""Build the port's kernels and host libraries once, ahead of a per-FOV
fan-out, and run each engine once (the port of
hiprfish_tpu/cli/warmup.py, same flags, plus --device):

    python -m hiprfish_tpu_torch.cli.warmup --family ecoli multispecies 3d --size 2000

On a fresh checkout the first process that launches a kernel runs nvcc
over ``csrc/*.cu`` (kernels/_build.py; a B6 stencil other than (11, 9,
9) adds one more library, which segment3d.warmup_pipeline builds), and
the first read of a ``.czi`` runs g++ over ``native/*.cc``
(io/_native_build.py). The build lock is per process, so N command lines
started together on a fresh checkout each run the compilers (the renames
keep every library whole, but the work is done N times). This command
does it once, in parallel, and prints each step's seconds to stderr.
``libczi_native.so`` is built where the compiler finds its zstd and
libjpeg headers; elsewhere the readers take the Python parser, and the
command says so. A failed build exits non-zero with the compiler's
output.

What carries over to later processes is the build directory only
(``build/torch_kernels/<hash>/``, ``build/torch_native/<hash>/``). The
CUDA context, cuFFT plans and the caching allocator's blocks belong to
this process, so every later process pays them again; running each
family once here (on zeros, as the JAX command runs the multispecies
engine) checks that the engines run on the card. The 3D family launches
B6, B5, B3 and B4 once on a small volume and allocates nothing at
``--shape3d``. With ``--device cpu`` there is nothing to build and the
families run on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from hiprfish_tpu_torch.cli import add_device_flag, resolve_device
from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT, SegmentationConfig


def _say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _zeros_stack(layout, size: int, device) -> tuple:
    return tuple(torch.zeros((size, size, hi - lo), dtype=torch.float32,
                             device=device) for lo, hi in layout.blocks)


def build_libraries() -> dict:
    """Build, in parallel, the kernel library (B1-B6, B6 at the default
    stencil), libjxr.so and, where its headers are found,
    libczi_native.so. Returns {step: seconds}; raises the first failed
    build's error (with the compiler's output)."""
    from hiprfish_tpu_torch.io import _native_build
    from hiprfish_tpu_torch.kernels import _build

    steps = {"kernel library": _build.build,
             "libjxr.so": lambda: _native_build.build("libjxr.so")}
    missing = _native_build.missing_headers("libczi_native.so")
    if missing:
        _say(f"libczi_native.so: not built, the compiler finds no "
             f"{', '.join(missing)}; .czi planes take the Python parser")
    else:
        steps["libczi_native.so"] = \
            lambda: _native_build.build("libczi_native.so")

    def timed(name, fn):
        t0 = time.time()
        path = fn()
        return name, time.time() - t0, path

    seconds = {}
    with ThreadPoolExecutor(len(steps)) as pool:
        jobs = [pool.submit(timed, k, v) for k, v in steps.items()]
        for job in jobs:
            name, s, path = job.result()
            seconds[name] = s
            _say(f"{name}: {s:.1f}s -> {path}")
    return seconds


def warmup_ecoli(size: int, max_cells: int, device) -> None:
    """The fused 10-bit engine and its measurement once on zeros."""
    from hiprfish_tpu_torch.pipeline import fused_ecoli, measure

    stack = _zeros_stack(TEN_BIT, size, device)
    t0 = time.time()
    seg, _, registered, _ = fused_ecoli.segment_ecoli_device(
        stack, SegmentationConfig(), max_cells)
    measure.measure_device(seg, registered, max_cells)
    _sync(device)
    _say(f"ecoli fused engine {size}^2 x{max_cells}: "
         f"{time.time() - t0:.1f}s")


def warmup_multispecies(size: int, max_cells: int, device) -> None:
    """The 7-bit LP-CV engine and its measurement once on zeros."""
    from hiprfish_tpu_torch.pipeline import measure, segment2d

    stack = _zeros_stack(SEVEN_BIT, size, device)
    t0 = time.time()
    res = segment2d.segment_lpcv(stack, None, SegmentationConfig(),
                                 max_cells, "multispecies")
    measure.measure_fov(res.segmentation, res.registered, 0, max_cells)
    _sync(device)
    _say(f"multispecies LP-CV path {size}^2: {time.time() - t0:.1f}s")


def warmup_3d(shape, max_cells: int, device) -> None:
    """warmup_pipeline for ``shape`` (which builds B6's library for a
    stencil other than the default), then B6, B5, B3 and B4 once each on
    a 16^3 volume of zeros (nothing is allocated at ``shape``)."""
    from hiprfish_tpu_torch.ops import line_profile as lp
    from hiprfish_tpu_torch.ops import segstats
    from hiprfish_tpu_torch.pipeline import segment3d

    cfg = SegmentationConfig()
    t0 = time.time()
    segment3d.warmup_pipeline(tuple(shape), cfg, max_cells=max_cells,
                              device=device)()
    vol = torch.zeros((16, 16, 16), dtype=torch.float32, device=device)
    labels = torch.zeros((16, 16, 16), dtype=torch.int32, device=device)
    lp.lp_cv_enhance_3d(vol, cfg.patch_size, cfg.theta_range,
                        cfg.phi_range, layout="xzy")
    segstats.stats_cm(labels, torch.zeros(
        (SEVEN_BIT.n_channels, 16, 16, 16), dtype=torch.bfloat16,
        device=device), max_cells)
    segstats.label_stats(labels, None, max_cells)
    segstats.label_lookup(labels, torch.zeros(max_cells, device=device))
    _sync(device)
    _say(f"3D pipeline {tuple(shape)}: {time.time() - t0:.1f}s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "Build the kernels and host libraries and run each engine once")
    p.add_argument("--family", nargs="*",
                   default=["ecoli", "multispecies"],
                   choices=["ecoli", "multispecies", "3d"])
    p.add_argument("--size", nargs="*", type=int, default=[2000],
                   help="2D FOV side length(s) to run")
    p.add_argument("--shape3d", nargs=3, type=int, default=[2020, 2020, 170],
                   help="3D volume shape (X Y Z) for --family 3d")
    p.add_argument("--max_cells", type=int, default=4096,
                   help="the CLIs' --max_cells")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    if device.type == "cuda":
        try:
            build_libraries()
        except RuntimeError as e:
            # nvcc's or g++'s output (NativeBuildError is a RuntimeError)
            print(f"warmup: build failed: {e}", file=sys.stderr)
            return 1
    for size in args.size:
        if "ecoli" in args.family:
            warmup_ecoli(size, args.max_cells, device)
        if "multispecies" in args.family:
            warmup_multispecies(size, args.max_cells, device)
    if "3d" in args.family:
        warmup_3d(args.shape3d, args.max_cells, device)
    _say(f"warmup complete in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
