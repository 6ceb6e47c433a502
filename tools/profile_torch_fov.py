"""Where the time of the port's 7-bit fov_step, of its 10-bit
fov_step_ecoli, of its 3D volume pass, or of a measure command line, goes
on one GPU.

    python tools/profile_torch_fov.py [--ecoli | --volume | --cli-measure
                                       | --cli-multispecies
                                       | --cell NAME [--fovs N]]
                                      [--out PATH]

Runs hiprfish_tpu_torch.pipeline.fused.fov_step on the 2000^2 7-bit FOV
(400 planted cells, the committed 127-code classifier, max_cells=8192);
with --ecoli fused_ecoli.fov_step_ecoli on the 2000^2 10-bit FOV of
chip_smoke.py phase 11 (400 planted cells, the committed 1023-class
classifier, max_cells=8192); with --cell a cell of BENCHMARK.json, its
step handed one FOV of the cell's scenes after another as the benchmark
hands them (``benchmark/programs``, rendered on the card from a fixed
seed, the rendering outside the spans), the profiled call N FOVs and its
span table per FOV; or with --volume the 3D pass of
chip_smoke.py phase 8 (segment3d.volume_step on tools/bench3d.py's 2020 x
2020 x 170 volume from 8 tiles: stitch -> segment_3d_tiled -> streamed
bf16 measurement -> classify; the slabs' rendering inside ``measure``);
with --cli-measure or --cli-multispecies the command line
cli.measure -c F (the 10-bit FOV's five .npy planes) or
cli.measure_multispecies (the 7-bit FOV's four planes) at its default
flags, in a temporary directory, from reading the planes to the written
artifacts; and reports:

  * per-stage time. The FOV and volume steps (the default, --ecoli,
    --cell, --volume) read it from the program's own spans
    (``hiprfish_tpu_torch.utils.logging``) in the one profiled call,
    nothing synchronised: for each span path (``step/markers/flood.ccl``)
    its calls, fixpoint rounds, the floods'
    CUDA graph replays and calls whose rounds ran csrc/flood.cu
    (``kernel``), host and host self time, the routed reads'
    ``wait_ns``, the blocking host calls, the device time and launches of
    the kernels and copies launched while it was the innermost
    ``hiprfish::`` range, and the card's idle time while it was
    (``span_table``). The command lines (--cli-*) wrap
    every op the step calls so that it synchronises the card before and
    after itself; the host clock between the two syncs is the stage's
    time (the syncs serialise the step, so the stages add up to more
    than an unwrapped call). A wrapped op called inside another wrapped
    op counts toward the outer one only;
  * the unwrapped step's wall time (median of 5) and, from one
    torch.profiler trace, the device time per kernel name and the device's
    idle share (1 - summed kernel time / wall time, against the profiled
    call's wall and against the unprofiled median).

The FOV, volume, classifier and cell capacities are chip_smoke.py's.
Needs a CUDA device; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fov_setup(torch, dev):
    """(step, stages) of the 2D fov_step."""
    from chip_smoke import FIXTURE, MAX_CELLS
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused
    from hiprfish_tpu_torch.utils import synthetic

    fov = synthetic.flagship_fov()
    clf = load_classifier(FIXTURE)
    arrays, static = fused.classifier_from_numpy(clf, dev)
    stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
    cfg = SegmentationConfig()

    def step():
        return fused.fov_step(stack, arrays, cfg, MAX_CELLS, static)

    return step, None, 5


def _ecoli_setup(torch, dev):
    """(step, stages) of the 10-bit fov_step_ecoli."""
    from chip_smoke import FIXTURE_10B, MAX_CELLS
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused, fused_ecoli
    from hiprfish_tpu_torch.utils import synthetic

    fov = synthetic.ecoli_fov()
    arrays, static = fused.classifier_from_numpy(
        load_classifier(FIXTURE_10B), dev)
    stack = tuple(torch.from_numpy(a).to(dev) for a in fov["stack"])
    del fov
    cfg = SegmentationConfig()

    def step():
        return fused_ecoli.fov_step_ecoli(stack, arrays, cfg, MAX_CELLS,
                                          static)

    return step, None, 5


def _cell_setup(torch, dev, name: str):
    """(step, stages) of a benchmark cell: each call renders the cell's
    next FOV and hands it to the cell's program."""
    import importlib.util

    def load(path):
        spec = importlib.util.spec_from_file_location(
            os.path.basename(path)[:-3], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    run = load(os.path.join(ROOT, "benchmark", "run.py"))
    import scenes

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        _, cfg, traffic = run.find_cell(json.load(f), name)
    program = load(os.path.join(ROOT, "benchmark", "programs",
                                cfg["program"] + ".py")).load(cfg, dev, {})
    fovs = scenes.Scenes(traffic, cfg["layout"], cfg["fov"], 2**31 + 777)
    index = [0]

    def step():
        stack, _, _ = fovs.make(index[0], dev)
        index[0] += 1
        return program.step(stack)

    return step, None, 5


def _volume_setup(torch, dev):
    """(step, stages) of the 3D pass, segment3d.volume_step on chip_smoke
    phase 8's tiles (built once and kept) and bf16 channels-major
    slabs."""
    import chip_smoke as cs
    from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused, segment3d
    from hiprfish_tpu_torch.utils import synthetic, synthetic3d as s3

    spec = s3.VolumeSpec(shape=cs.SHAPE_3D, spacing=(36, 36, 52), seed=5)
    lut = np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                    for c in range(1, 128)])
    lut_dev = torch.from_numpy(lut.astype(np.float32)).to(dev)
    tiles = cs._volume_tiles(torch, dev, spec, lut_dev)
    arrays, static = fused.classifier_from_numpy(
        load_classifier(cs.FIXTURE), dev)

    def slabs(z0, zc):
        return s3.channel_chunk_cm(spec, lut_dev.shape[0], z0, zc, lut_dev,
                                   1, torch.bfloat16)

    def step():
        return segment3d.volume_step(
            [list(tiles)], slabs, arrays, static, SegmentationConfig(),
            cs.MAX_CELLS_3D, grid=(2, 4), overlap=60, **cs.TILED_3D)

    return step, None, 3


def _cli_setup(torch, dev, multispecies: bool):
    """(step, stages) of one measure command line on .npy planes written
    once into a temporary directory, removed with the step; each step runs
    the CLI's main there (artifacts overwritten)."""
    import tempfile

    import chip_smoke as cs
    from hiprfish_tpu_torch.cli import measure as cli_measure
    from hiprfish_tpu_torch.cli import measure_multispecies as cli_ms
    from hiprfish_tpu_torch.io import outputs
    from hiprfish_tpu_torch.pipeline import fused_ecoli, measure, segment2d
    from hiprfish_tpu_torch.utils import synthetic

    tmp = tempfile.TemporaryDirectory()
    fov = synthetic.flagship_fov() if multispecies else synthetic.ecoli_fov()
    lasers = cs.LASERS_7B if multispecies else cs.LASERS_10B
    names = [os.path.join(tmp.name, f"fov_{laser}.npy") for laser in lasers]
    for name, plane in zip(names, fov["stack"]):
        np.save(name, plane)
    del fov
    main = cli_ms.main if multispecies else cli_measure.main
    argv = ["-i", *names] + ([] if multispecies else ["-c", "F"])

    def step():
        cwd = os.getcwd()
        os.chdir(tmp.name)
        try:
            main(argv)
        finally:
            os.chdir(cwd)

    m = segment2d
    stages = [
        (cli_measure.iio, "load_image_stack", "read .npy planes"),
        (m.reg, "register_translation", "register: FFT shift"),
        (m.reg, "apply_shift_2d", "register: apply shift"),
        (measure, "measure_fov", "measure_fov (spectra to host)"),
        (np, "save", "np.save (_seg, _registered)"),
        (outputs, "write_png", "PNG writes"),
        (outputs, "write_csv", "CSV writes (header)"),
        (np, "savetxt", "CSV writes (savetxt)"),
    ]
    if multispecies:
        stages += [
            (m.dn, "denoise_nl_means_auto", "NLM (kernel B1)"),
            (m.lp, "lp_cv_enhance_2d", "LP-CV (kernel B2)"),
            (m.km, "brightest_cluster_mask", "KMeans"),
            (m.morph, "binary_opening", "opening"),
            (m.lab, "remove_small_objects", "small objects (CCL)"),
            (m.morph, "binary_fill_holes", "fill holes"),
            (m.lab, "label", "CCL"),
            (m.lab, "relabel_sequential", "relabel"),
            (m.ws, "watershed", "watershed"),
            (m.lab, "filter_and_relabel", "size/border filter"),
        ]
    else:
        stages += [(fused_ecoli, "segment_ecoli_device",
                    "segment_ecoli_device (B3, B4)")]
    return step, stages, 3


def _paths(records):
    """{record id: 'step/markers/flood.ccl'} from the records' parents."""
    by_id = {r["id"]: r for r in records}
    out = {}
    for r in records:
        names, q = [], r
        while q is not None:
            names.append(q["name"])
            q = by_id.get(q["parent"])
        out[r["id"]] = "/".join(reversed(names))
    return out


# host calls that block until the device has caught up
SYNC_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
    "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2"))


def span_table(prof, records) -> dict:
    """{span path: calls, rounds, replays, kernel, host_ms, self_host_ms,
    wait_ms, sync_ms, syncs, device_ms, launches, idle_ms} of a profiled
    run. The host columns come from the span records (``replays``: a
    flood's graph replays; ``kernel``: its calls whose rounds ran
    csrc/flood.cu; ``wait_ms``: the reads routed through ``host_wait``); the
    others from the profiler, each event given to the innermost
    ``hiprfish::`` range around it on the host: every blocking host call
    (``syncs``, and its time ``sync_ms``), every kernel or copy by its
    launch, the runtime call of the same correlation id (``device_ms``; ``launches`` counts the kernels, not
    the copies), and every gap in the device's activity by the host's
    place at its middle (``idle_ms``). What lies outside every range is
    ``(outside spans)``."""
    import numpy as np
    import torch

    from hiprfish_tpu_torch.utils.logging import SPAN_PREFIX

    paths = _paths(records)
    child_ns = collections.Counter()
    for r in records:
        if r["parent"] is not None:
            child_ns[r["parent"]] += r["end_ns"] - r["start_ns"]
    rows = collections.defaultdict(lambda: dict.fromkeys(
        ("calls", "rounds", "replays", "kernel", "host_ms", "self_host_ms",
         "wait_ms", "sync_ms", "syncs", "device_ms", "launches", "idle_ms"),
        0))
    for r in records:
        row = rows[paths[r["id"]]]
        dur = r["end_ns"] - r["start_ns"]
        row["calls"] += 1
        row["rounds"] += r["attrs"].get("rounds", 0)
        row["replays"] += r["attrs"].get("replays", 0)
        row["kernel"] += r["attrs"].get("kernel", 0)
        row["host_ms"] += dur / 1e6
        row["self_host_ms"] += (dur - child_ns[r["id"]]) / 1e6
        row["wait_ms"] += r["attrs"].get("wait_ns", 0) / 1e6

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type() == cuda
           and not e.is_user_annotation()]
    cpu = [e for e in events if e.device_type() != cuda]
    launch = {e.correlation_id(): e.start_ns() for e in cpu
              if e.name().startswith("cu")}
    # the ranges, properly nested: sorted by start (outer first), each
    # with its enclosing range and its path
    ranges = sorted((e.start_ns(), -e.end_ns(), e.name()[len(SPAN_PREFIX):])
                    for e in cpu if e.is_user_annotation()
                    and e.name().startswith(SPAN_PREFIX))
    starts = [a for a, _, _ in ranges]
    parent, rpath, stack = [], [], []
    for i, (a, _, name) in enumerate(ranges):
        while stack and -ranges[stack[-1]][1] < a:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        rpath.append(name if not stack else rpath[stack[-1]] + "/" + name)
        stack.append(i)

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        while i is not None and i >= 0 and -ranges[i][1] < t:
            i = parent[i]
        return rpath[i] if i is not None and i >= 0 else "(outside spans)"

    for e in cpu:
        if e.name() in SYNC_CALLS:
            row = rows[innermost(e.start_ns())]
            row["syncs"] += 1
            row["sync_ms"] += e.duration_ns() / 1e6
    busy = []
    for e in dev:
        t = launch.get(e.correlation_id())
        row = rows["(outside spans)" if t is None else innermost(t)]
        row["device_ms"] += e.duration_ns() / 1e6
        row["launches"] += not e.name().startswith(("Memcpy", "Memset"))
        busy.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    if busy:
        iv = np.asarray(sorted(busy), np.int64)
        reach = np.maximum.accumulate(iv[:, 1])
        for a, b in zip(reach[:-1].tolist(), iv[1:, 0].tolist()):
            if b > a:
                rows[innermost((a + b) // 2)]["idle_ms"] += (b - a) / 1e6
    return dict(sorted(rows.items()))


# the device functions of csrc/ (B1-B6 and B3's moments pass)
PORT_KERNELS = ("nlm_", "lpcv2d_", "label_stats_kernel", "moments_to_table",
                "label_lookup_kernel", "stats_cm_kernel", "lpcv3d_",
                "flood_neighbor_kernel", "flood_runs_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--ecoli", action="store_true",
                       help="profile the 10-bit fov_step_ecoli")
    which.add_argument("--volume", action="store_true",
                       help="profile the 3D volume pass")
    which.add_argument("--cli-measure", action="store_true",
                       help="profile the 10-bit measure command line")
    which.add_argument("--cli-multispecies", action="store_true",
                       help="profile the 7-bit measure command line")
    which.add_argument("--cell", default=None,
                       help="profile a cell of BENCHMARK.json by name")
    ap.add_argument("--fovs", type=int, default=5,
                    help="FOVs in the profiled call of --cell")
    ap.add_argument("--out", default=None,
                    help="JSON output (default build/profile_torch_fov.json"
                    ", or build/profile_torch_<ecoli | volume | "
                    "cli_measure | cli_multispecies | cell name>.json)")
    args = ap.parse_args()
    kind = ("volume" if args.volume else "ecoli" if args.ecoli
            else "cli_measure" if args.cli_measure
            else "cli_multispecies" if args.cli_multispecies
            else args.cell if args.cell else "fov")
    out = args.out or os.path.join(ROOT, "build",
                                   f"profile_torch_{kind}.json")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_fov: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    setup = {"fov": _fov_setup, "ecoli": _ecoli_setup,
             "volume": _volume_setup,
             "cli_measure": lambda t, d: _cli_setup(t, d, False),
             "cli_multispecies": lambda t, d: _cli_setup(t, d, True)}.get(
                 kind, lambda t, d: _cell_setup(t, d, args.cell))
    step, stages, reps = setup(torch, dev)
    from hiprfish_tpu_torch.utils.logging import RECORDER, SPAN_PREFIX
    what = {"fov": "fov_step", "ecoli": "fov_step_ecoli",
            "volume": "3D pass", "cli_measure": "cli.measure",
            "cli_multispecies": "cli.measure_multispecies"}.get(
                kind, f"{kind} (per FOV, rendering included)")
    calls = args.fovs if args.cell else 1

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))

    # per-stage times of the other modes: wrap the ops the step calls,
    # syncing around each
    stage_ms = collections.defaultdict(float)
    stage_calls = collections.Counter()
    wrapped = []
    depth = [0]

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def timed(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            depth[0] += 1
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            stage_ms[label] += (time.perf_counter() - t0) * 1e3
            stage_calls[label] += 1
            return out

        setattr(mod, name, timed)
        wrapped.append((mod, name, fn))

    synced_ms = None
    if stages is not None:
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

    RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    spans = None
    if stages is None:
        spans = {path: {k: v / calls for k, v in row.items()}
                 for path, row in span_table(prof, RECORDER.snapshot())
                 .items()}
    RECORDER.reset()
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        # the spans' ranges show on the device's timeline too: not kernels
        if dt and ev.device_type.name == "CUDA" \
                and not ev.key.startswith(SPAN_PREFIX):
            rows.append((ev.key, dt / 1e3 / calls, ev.count // calls))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)

    result = {
        "card": card,
        "what": what,
        "wall_ms_median": wall_ms,
        "wall_ms_all": walls,
        "synced_stages_total_ms": synced_ms,
        "stages_ms": dict(sorted(stage_ms.items(), key=lambda kv: -kv[1])),
        "stage_calls": dict(stage_calls),
        "spans": spans,
        "profiled_wall_ms": prof_wall_ms,
        "device_kernel_ms": device_ms,
        # the profiler slows the host, so the profiled call's idle share is
        # an upper bound; against the unprofiled median wall, a lower one
        "device_idle_share": (1.0 - device_ms / prof_wall_ms
                              if prof_wall_ms else None),
        "device_idle_share_vs_unprofiled_wall": 1.0 - device_ms / wall_ms,
        "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                        for n, ms, c in rows[:25]],
        # the port's own kernels (csrc/), whatever their rank
        "port_kernels": [{"name": n[:120], "ms": ms, "count": c}
                         for n, ms, c in rows
                         if any(k in n for k in PORT_KERNELS)],
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"card: {card}")
    print(f"{what} wall {wall_ms:.1f} ms (median of {reps})")
    if spans is not None:
        print("spans of the profiled call, per FOV (ms, but calls, rounds, "
              "replays, kernel, syncs and launches):")
        keys = list(next(iter(spans.values())))
        print(f"  {'path':36s}" + "".join(f"{k:>13s}" for k in keys))
        for path, r in spans.items():
            print(f"  {path:36s}" + "".join(f"{r[k]:13.2f}" for k in keys))
    else:
        print(f"with per-stage syncs {synced_ms:.1f} ms")
        for k, v in result["stages_ms"].items():
            print(f"  {k:30s} {v:9.2f} ms  x{stage_calls[k]}")
    print(f"profiled call: wall {prof_wall_ms:.1f} ms, kernels "
          f"{device_ms:.1f} ms, idle share "
          f"{result['device_idle_share']:.3f} (vs the unprofiled wall "
          f"{result['device_idle_share_vs_unprofiled_wall']:.3f})")
    for r in result["top_kernels"][:15]:
        print(f"  {r['ms']:9.2f} ms x{r['count']:6d}  {r['name']}")
    print("the port's kernels:")
    for r in result["port_kernels"]:
        print(f"  {r['ms']:9.2f} ms x{r['count']:6d}  {r['name']}")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
