"""The benchmark of hiprfish_tpu_torch, the PyTorch and CUDA port: one cell
of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

A cell names a configuration (``configs/<name>.json``: the layout, the
unit's size ``fov``, the program that drives the port
(``programs/<program>.py``), its entry and flags, the classifier and the
plain reference ``configs/<name>.py``) and a traffic mix
(``traffic/<name>.json``: the parameters its source of work reads);
``limits/<cell>.json`` holds the limits of its comparison,
``e2e/<metric>.py`` and ``metrics/<metric>.py`` read the end-to-end and
per-layer metrics. Every file is found by its name in BENCHMARK.json.

Two keys of a configuration are optional:

* ``"scenes"``: the module ``benchmark/<scenes>.py`` that is the cell's
  source of work (default ``scenes``, the 2D fields of view). The run
  builds ``Scenes(traffic, layout, fov, seed)`` from it once, then calls
  ``make(index, device)`` for unit ``index``, which returns ``(stack,
  truth, plan)``: ``stack`` is what the program's ``step`` and the
  reference's ``run`` take, rendered on the device from (seed, index)
  alone, so that the same pair gives the same unit; the harness reads
  neither ``truth`` nor ``plan``. The rendering counts in the window but
  falls outside the unit's latency.
* ``"check_samples"``: how many of the window's results are checked
  against the reference (default ``SAMPLE_SIZE``, 4; at least 1).

A "FOV" in the metrics' names is one unit of that source: a field of
view, or, for a source of volumes, one volume.

The run is the port's one-card sweep, one process: it loads the program,
warms it up on two units, then for ``--seconds`` hands one unit after
another to the step and reads each result back to the host. Every unit
is rendered anew on the card from (seed, index) before it is handed in,
outside its latency. With ``--trace 0`` the last line of standard output
holds the end-to-end metrics; with ``--trace 1`` the per-layer metrics,
read from a profiled slice in the middle of the window. After the
window, the program's state freed, a sample of the window's results drawn
from the seed is checked against the plain reference; ``correct`` is
whether every compared number stays within its limit. The compared
numbers and their limits are the last lines of standard error and the
last key of the result.

The run exits non-zero and prints no result without enough CUDA devices,
or when jax, jaxlib, flax or the JAX package is loaded.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.monotonic()
ROOT = os.getcwd()
# caches of the program at fixed paths inside the checkout, and one thread
# of host work, all set before torch is imported
os.environ.update({
    "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton_cache"),
    "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "USE_FLAX": "0"})

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import compare  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hiprfish_tpu")
# the share of the window that a traced run profiles, in its middle
PROFILE_SHARE = 0.2
PROFILE_MAX_S = 3.0
# window results checked against the reference in each run, unless the
# configuration's "check_samples" says otherwise
SAMPLE_SIZE = 4
# FOVs stepped in the warm-up, before the window
WARM_FOVS = 2


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, prefix: str):
    """The module in file ``path``."""
    name = prefix + os.path.basename(path)[:-3].replace(".", "_") \
        .replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, workload: str):
    """(cell, configuration dict, traffic dict), from the files its names
    lead to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    cdir = os.path.dirname(os.path.join(ROOT, conf["file"]))
    cfg["classifier_path"] = os.path.join(cdir, cfg["classifier"])
    cfg["reference_path"] = os.path.join(cdir, cfg["reference"])
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, cfg, traffic


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def device_facts() -> dict:
    """The card's name, clocks and power limit, and the host's cores."""
    facts = {"nproc": os.cpu_count()}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        facts["nvidia_smi"] = out
    except (OSError, subprocess.SubprocessError) as e:
        facts["nvidia_smi"] = f"unavailable: {e}"
    return facts


class Faulty:
    """A program with a planted fault (the harness's own tests): the
    previous FOV's result, half of the cells left out, or one call
    altered where it is made."""

    def __init__(self, program, fault: str, n_codes: int):
        self.program, self.fault, self.n_codes = program, fault, n_codes
        self.last = None

    def step(self, stack) -> dict:
        host = self.program.step(stack)
        if self.fault == "stale":
            prev, self.last = self.last, host
            return prev if prev is not None else host
        host = dict(host)
        if self.fault == "drop_half":
            lab = host["labels"]
            host["labels"] = np.where(lab % 2 == 0, 0, lab).astype(lab.dtype)
        elif self.fault == "alter_call":
            code = host["code"].copy()
            code[len(code) // 2] = (code[len(code) // 2] + 1) % self.n_codes
            host["code"] = code
        else:
            raise ValueError(f"unknown fault {self.fault!r}")
        return host

    def free(self) -> None:
        self.program.free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the harness's own checks; a cell never sets them
    ap.add_argument("--program", choices=("port", "control"),
                    default="port",
                    help="control: the reference in bfloat16 in the "
                    "program's place")
    ap.add_argument("--fault", default="none",
                    choices=("none", "stale", "drop_half", "alter_call"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the harness's CPU tests only")
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, cfg, traffic = find_cell(bench, args.workload)
    setup = {"start_s": process_age_s()}
    t0 = time.perf_counter()
    import torch

    setup["import_torch_s"] = time.perf_counter() - t0
    if args.device == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    try:
        return run(args, bench, cell, cfg, traffic, setup)
    except Exception:
        log(traceback.format_exc())
        return 1


def run(args, bench, cell, cfg, traffic, setup) -> int:
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda":
        log("host:", json.dumps(device_facts()))
        t0 = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=dev)
        setup["device_context_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        from hiprfish_tpu_torch.kernels import _build
        _build.build()
        setup["kernel_build_s"] = time.perf_counter() - t0
    reference = load_file(cfg["reference_path"], "reference_")
    prog_name = cfg["program"] if args.program == "port" else "control"
    prog_mod = load_file(os.path.join(HERE, "programs", prog_name + ".py"),
                         "program_")
    program = prog_mod.load(cfg, dev, setup, reference=reference)
    if args.fault != "none":
        program = Faulty(program, args.fault,
                         2 ** cfg["layout"]["n_bits"] - 1)
    spans = None
    if args.trace:
        import tracing
        spans = tracing.OpSpans(prog_mod.KERNEL_ENTRIES)

    n_check = int(cfg.get("check_samples", SAMPLE_SIZE))
    if n_check < 1:
        raise ValueError(f"check_samples must be at least 1, not {n_check}")
    scenes = importlib.import_module(cfg.get("scenes", "scenes"))

    t0 = time.perf_counter()
    fovs = scenes.Scenes(traffic, cfg["layout"], cfg["fov"], args.seed)
    setup["geometries_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm_cells = []
    for i in range(WARM_FOVS):
        stack, _, _ = fovs.make(i, dev)
        warm_cells.append(program.step(stack)["n_cells"])
        del stack
    sync(dev)
    setup["warmup_s"] = time.perf_counter() - t0
    if args.trace:
        # the profiler's first start loads its tracing library: done here,
        # so that a start in the window takes no longer than a FOV
        t0 = time.perf_counter()
        stop_profiler(start_profiler(spans, dev), spans, dev)
        spans.calls = []
        setup["profiler_warmup_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = process_age_s()
    log("set-up:", json.dumps({k: round(v, 4) for k, v in setup.items()}),
        "setup_s:", setup_s, "cells in the warm-up FOVs:", warm_cells)

    w = window(args, program, fovs, dev, spans, n_check)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {len(w['latencies_s'])} FOVs completed of {w['attempted']} "
        f"handed in, {w['failed']} failed; rendering {w['render_s']:.3f} s "
        f"of {args.seconds} s")
    if w["latencies_s"]:
        lat = np.asarray(w["latencies_s"]) * 1e3
        log("latency ms: median", statistics.median(lat.tolist()), "p95",
            float(np.percentile(lat, 95)), "max", float(lat.max()))

    metrics = {}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu", "count": cell["chips"],
              "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        summary = w["summary"]
        if summary is None:
            log("the window is too short for its profiled slice")
            return 1
        reading = summary.reading()
        log("trace:", json.dumps(reading))
        reading["latencies_s"] = w["latencies_s"]
        device["busy_s"] = reading["busy_s"]
        device["window_s"] = reading["window_s"]
        for m in metrics_of(bench, "per_layer", args.workload):
            v = load_file(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "metric_").read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = summary.breakdown()
    else:
        record = {"setup_s": setup_s, "seconds": args.seconds,
                  "latencies_s": w["latencies_s"]}
        for m in metrics_of(bench, "end_to_end", args.workload):
            v = load_file(os.path.join(HERE, "e2e", m["name"] + ".py"),
                          "e2e_").read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check: the program's state is freed first, the reference runs
    # after, on the sampled FOVs rendered again from (seed, index)
    w.pop("summary", None)
    program.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check(cfg, reference, fovs, w["samples"], dev)
    log("check:", round(time.perf_counter() - t0, 3), "s, FOVs",
        [idx for idx, _ in w["samples"]])

    forbidden = sorted({m.split(".")[0] for m in sys.modules}
                       & set(FORBIDDEN))
    if forbidden:
        log("forbidden modules loaded:", forbidden)
        return 3
    numbers = compare.worst(checks)
    limits = load_json(os.path.join(HERE, "limits",
                                    args.workload + ".json"))
    compared = {name: {"value": numbers.get(name), "limit": lim}
                for name, lim in limits.items()}
    correct = (bool(w["latencies_s"]) and w["failed"] == 0
               and len(checks) == min(n_check, len(w["latencies_s"]))
               and all(numbers.get(n) is not None and numbers[n] <= lim
                       for n, lim in limits.items()))
    log("other numbers:", json.dumps({n: v for n, v in numbers.items()
                                      if n not in limits}))
    result = {"correct": bool(correct), "attempted": int(w["attempted"]),
              "failed": int(w["failed"]), "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    for name, c in compared.items():
        log(f"compared {name}: {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(args, program, fovs, dev, spans, n_check: int) -> dict:
    """The measured window: FOVs WARM_FOVS, WARM_FOVS + 1, ... each
    rendered, then handed to the step, until ``--seconds`` have passed. A
    FOV counts where its result reached the host inside the window; a
    reservoir sample drawn from the seed keeps ``n_check`` of those. In a
    traced run the profiler records whole FOVs around the middle slice."""
    from torch.profiler import record_function

    import tracing

    rng = np.random.default_rng(np.random.SeedSequence(
        [int(args.seed), 0x5A4D]))
    prof_span = None
    if args.trace:
        length = min(PROFILE_SHARE * args.seconds, PROFILE_MAX_S)
        mid = args.seconds / 2
        prof_span = (mid - length / 2, mid + length / 2)
    latencies, samples = [], []
    attempted = failed = n_prof = 0
    render_s = 0.0
    prof = stopped = None
    index = WARM_FOVS
    t_start = time.monotonic()
    t_end = t_start + args.seconds
    while True:
        t = time.monotonic()
        if t >= t_end:
            break
        if prof_span is not None:
            if prof is None and stopped is None \
                    and t - t_start >= prof_span[0]:
                prof = start_profiler(spans, dev)
            elif prof is not None and t - t_start >= prof_span[1]:
                stop_profiler(prof, spans, dev)
                stopped, prof = prof, None
        t = time.monotonic()
        with record_function(tracing.HARNESS_RANGE):
            stack, _, _ = fovs.make(index, dev)
        t0 = time.monotonic()
        render_s += t0 - t
        if t0 >= t_end:
            break
        attempted += 1
        try:
            host = program.step(stack)
        except Exception:
            failed += 1
            log(traceback.format_exc())
            index += 1
            continue
        t1 = time.monotonic()
        del stack
        if t1 > t_end:
            break
        if prof is not None:
            n_prof += 1
        latencies.append(t1 - t0)
        if len(samples) < n_check:
            samples.append((index, host))
        else:
            r = int(rng.integers(len(latencies)))
            if r < n_check:
                samples[r] = (index, host)
        index += 1
    if prof is not None:
        stop_profiler(prof, spans, dev)
        stopped = prof
    sync(dev)
    summary = None
    if stopped is not None:
        summary = tracing.Summary(stopped, n_prof, spans.ops,
                                  spans.take_bounds(), dev.type == "cuda")
    return {"latencies_s": latencies, "attempted": attempted,
            "failed": failed, "samples": samples, "summary": summary,
            "render_s": render_s}


def check(cfg, reference, fovs, samples, dev) -> list:
    """The compared numbers of each sampled result against the plain
    reference in the precision the configuration states."""
    from plainref import precision
    from plainref.classify import Classifier

    clf = Classifier(cfg["classifier_path"], dev)
    out = []
    for idx, host in samples:
        stack, _, _ = fovs.make(idx, dev)
        ref = reference.run(stack, clf, cfg["segmentation"],
                            cfg["max_cells"], precision.FLOAT32)
        del stack
        n = ref["n_cells"]
        ref = {"n_cells": n, "labels": ref["labels"].cpu().numpy(),
               "avgint": ref["avgint"][1:n + 1].cpu().numpy(),
               "code": ref["code"].cpu().numpy(),
               "prob": ref["prob"].cpu().numpy(),
               "scores": ref["scores"].cpu().numpy()}
        out.append(compare.numbers(host, ref))
    return out


def start_profiler(spans, dev):
    from torch.profiler import ProfilerActivity, profile, record_function

    import tracing

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    spans.active = True
    with record_function(tracing.MARK_ON):
        pass
    return prof


def stop_profiler(prof, spans, dev) -> None:
    from torch.profiler import record_function

    import tracing

    with record_function(tracing.MARK_OFF):
        pass
    spans.active = False
    sync(dev)
    prof.stop()


if __name__ == "__main__":
    sys.exit(main())
