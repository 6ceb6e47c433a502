"""A small checkout of the benchmark for its CPU tests: BENCHMARK.json and
``benchmark/`` copied into a temporary folder beside the port, every FOV
cut to 256 x 256 px and every traffic to two clients, and a runner of
``benchmark/run.py`` there on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
SMALL_FOV = [256, 256]


def make(tmp: Path) -> Path:
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    os.symlink(REPO / "hiprfish_tpu_torch", tmp / "hiprfish_tpu_torch")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = tmp / c["file"]
        cfg = json.loads(p.read_text())
        cfg["fov"] = SMALL_FOV
        cfg["max_cells"] = 256
        p.write_text(json.dumps(cfg))
    for p in (tmp / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["pool_size"] = 4
        if t["geometry"] == "grid":
            t["n_cells"] = 16
        p.write_text(json.dumps(t))
    return tmp


def run(tmp: Path, workload: str, *extra: str, seconds: float = 4,
        trace: int = 0, seed: int = 2**31 + 12345):
    """(return code, last line of stdout as JSON or None, stderr)."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace), "--device", "cpu", *extra]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                          env=env, timeout=600)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines else None
    return proc.returncode, last, proc.stderr
