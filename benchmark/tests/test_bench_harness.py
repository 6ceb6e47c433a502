"""The benchmark harness end to end on the CPU, at 256 x 256 px with two
a pool of four geometries: its result line, cells and metrics found by name
from new files only, and the comparison that decides ``correct`` failing the control and
each planted fault."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

import bench_checkout

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return bench_checkout.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_exactly_its_keys(checkout, trace):
    rc, last, err = bench_checkout.run(checkout, "ec10b-confluent-sweep",
                                       trace=trace, seconds=12)
    assert rc == 0, err[-3000:]
    assert set(last) == KEYS | ({"breakdown"} if trace else set())
    assert list(last)[-1] == "compared"
    assert last["correct"] is True, err[-3000:]
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    want = {m["name"] for m in (bench["per_layer"] if trace
                                else bench["end_to_end"])}
    if trace:
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert last["device"]["busy_s"] > 0
        # the CPU has no roofline; every other reader finds its numbers
        want -= {"kernels.roofline_share"}
    assert want <= set(last["metrics"])
    for c in last["compared"].values():
        assert c["value"] <= c["limit"]


def test_new_cell_config_and_metric_run_by_name(tmp_path):
    root = bench_checkout.make(tmp_path)
    bench_dir = root / "benchmark"
    before = _digest(bench_dir)
    shutil.copy(bench_dir / "configs" / "ec10b-fov2000.json",
                bench_dir / "configs" / "ec10b-copy.json")
    cfg = json.loads((bench_dir / "configs" / "ec10b-copy.json").read_text())
    cfg["name"] = "ec10b-copy"
    (bench_dir / "configs" / "ec10b-copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "sparse10b.json")
                         .read_text())
    traffic["n_cells"] = 9
    (bench_dir / "traffic" / "sparse10b-nine.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench_dir / "limits" / "ec10b-sparse-sweep.json",
                bench_dir / "limits" / "ec10b-copy.nine.json")
    (bench_dir / "metrics" / "step.fovs_profiled.py").write_text(
        "def read(trace):\n    return float(trace['n_fovs'])\n")
    (bench_dir / "e2e" / "fov_ms_p50.py").write_text(
        "import statistics\n\ndef read(window):\n"
        "    return 1e3 * statistics.median(window['latencies_s'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="ec10b-copy",
                                 file="benchmark/configs/ec10b-copy.json"))
    bench["workloads"].append({"name": "ec10b-copy.nine",
                               "config": "ec10b-copy",
                               "traffic": "sparse10b-nine", "chips": 1,
                               "why": "a cell added by files alone"})
    bench["per_layer"].append({"name": "step.fovs_profiled", "unit": "FOV",
                               "better": "higher", "source": "device_trace",
                               "layer": "step", "moves": "fov_per_s",
                               "workloads": ["ec10b-copy.nine"]})
    bench["end_to_end"].append({"name": "fov_ms_p50", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["ec10b-copy.nine"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, last, err = bench_checkout.run(root, "ec10b-copy.nine", trace=1,
                                       seconds=12)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True
    assert last["metrics"]["step.fovs_profiled"]["value"] >= 1
    rc, last, err = bench_checkout.run(root, "ec10b-copy.nine", seconds=4)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True
    assert last["metrics"]["fov_ms_p50"]["value"] > 0
    after = _digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload", ["ms7b-confluent-sweep",
                                      "ec10b-confluent-sweep",
                                      "ms7b-sparse-sweep"])
def test_control_is_not_correct(checkout, workload):
    """The reference in bfloat16 in the program's place fails the
    comparison."""
    rc, last, err = bench_checkout.run(checkout, workload, "--program",
                                       "control", seconds=3)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["compared"]


@pytest.mark.parametrize("fault", ["stale", "drop_half", "alter_call"])
def test_planted_fault_is_not_correct(checkout, fault):
    """A step that answers with the previous FOV's result, one that leaves
    out half of the cells, and one call altered where it is made."""
    rc, last, err = bench_checkout.run(checkout, "ec10b-confluent-sweep",
                                       "--fault", fault, seconds=3)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["compared"]


def test_no_result_without_a_card(checkout):
    """Without a CUDA device the run fails and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ec10b-confluent-sweep", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=checkout, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark's
    files, the run fails and prints no result."""
    shutil.copytree(bench_checkout.BENCH, tmp_path / "benchmark")
    shutil.copy(bench_checkout.REPO / "BENCHMARK.json", tmp_path)
    rc, last, err = bench_checkout.run(tmp_path, "ec10b-confluent-sweep")
    assert rc != 0
    assert last is None
