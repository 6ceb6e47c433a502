"""A small checkout of the benchmark for its CPU tests: BENCHMARK.json and
``benchmark/`` copied into a temporary folder beside the port, every
configuration cut to its CPU size and every traffic to a pool of four
geometries, and a runner of ``benchmark/run.py`` there on the CPU.

A configuration's CPU size is its optional ``"cpu_test"`` object, whose
keys replace the configuration's own (``fov``, ``max_cells``, ...);
without one, ``fov`` becomes 256 x 256 px and ``max_cells`` 256. A
traffic's ``pool_size`` becomes 4 and a ``"grid"`` geometry's ``n_cells``
16, where the traffic has those keys; it keeps every other parameter."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
# a configuration's CPU size where it brings no "cpu_test"
CPU_TEST = {"fov": [256, 256], "max_cells": 256}
# run.py under a counting clock: time.monotonic advances one second at each
# reading, so that a window holds the same units on any machine (four
# readings a unit in an untraced run)
COUNTED = """
import itertools, runpy, sys, time
ticks = itertools.count()
time.monotonic = lambda: float(next(ticks))
sys.argv[0] = "benchmark/run.py"
runpy.run_path("benchmark/run.py", run_name="__main__")
"""


def make(tmp: Path) -> Path:
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    os.symlink(REPO / "hiprfish_tpu_torch", tmp / "hiprfish_tpu_torch")
    return shrink(tmp)


def shrink(tmp: Path) -> Path:
    """Cut every configuration that BENCHMARK.json names and every traffic
    file to its CPU size; files already cut are written again unchanged."""
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = tmp / c["file"]
        cfg = json.loads(p.read_text())
        cfg.update(cfg.get("cpu_test", CPU_TEST))
        p.write_text(json.dumps(cfg))
    for p in (tmp / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        if "pool_size" in t:
            t["pool_size"] = 4
        if t.get("geometry") == "grid":
            t["n_cells"] = 16
        p.write_text(json.dumps(t))
    return tmp


def run(tmp: Path, workload: str, *extra: str, seconds: float = 4,
        trace: int = 0, seed: int = 2**31 + 12345, counted: bool = False):
    """(return code, last line of stdout as JSON or None, stderr); with
    ``counted``, under the counting clock of COUNTED."""
    head = ["-c", COUNTED] if counted else ["benchmark/run.py"]
    cmd = [sys.executable, *head, "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace), "--device", "cpu", *extra]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                          env=env, timeout=600)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines else None
    return proc.returncode, last, proc.stderr
