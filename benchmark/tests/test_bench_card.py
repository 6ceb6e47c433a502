"""The benchmark's cells on the card, at their own sizes: the port's run is
correct and the bfloat16 control in its place is not. Needs an NVIDIA
GPU and nvcc; skips without them.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false here)")


def _run(cell: str, seed: int, *extra: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", *extra], cwd=REPO,
        capture_output=True, text=True, timeout=1200,
        env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_port_is_correct_and_control_is_not(card, cell):
    assert _run(cell, 2**31 + 17)["correct"] is True
    for seed in (2**31 + 18, 2**31 + 19, 2**31 + 20):
        got = _run(cell, seed, "--program", "control")
        assert got["correct"] is False, got["compared"]
