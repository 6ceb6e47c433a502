"""The benchmark harness end to end on the CPU, at 256 x 256 px with a
pool of four geometries: its result line, cells and metrics found by name
from new files only (a 3D configuration with its own source of work and
check size among them), the sample of checked results and its numbers as
they were before configurations could name those, and the comparison that
decides ``correct`` failing the control and each planted fault."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

import bench_checkout

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}

# Recorded with the harness as it was before configurations could name
# their source of work and check size: under bench_checkout's counting
# clock, (seconds, seed) -> units attempted, the sampled units, the
# compared numbers and the other numbers of the check.
BEFORE = {
    "ms7b-confluent-sweep": (
        (24, 2**31 + 101), 6, [6, 3, 4, 5],
        {"cells_changed": 0, "spectra_gap": 0.0, "vote_gap": 0.0},
        {"px_gap": 0, "cells_gap": 0, "cells_identical": 34,
         "cells_ref": 34}),
    "ec10b-confluent-sweep": (
        (80, 2**31 + 202), 20, [19, 8, 6, 5],
        {"px_gap": 0, "spectra_gap": 0.0, "vote_gap": 0.0},
        {"cells_changed": 0, "cells_gap": 0, "cells_identical": 27,
         "cells_ref": 27}),
    "ms7b-sparse-sweep": (
        (24, 2**31 + 303), 6, [2, 6, 7, 5],
        {"cells_changed": 0, "spectra_gap": 0.0, "vote_gap": 0.0},
        {"px_gap": 0, "cells_gap": 0, "cells_identical": 16,
         "cells_ref": 16}),
    "ec10b-sparse-sweep": (
        (80, 2**31 + 404), 20, [10, 9, 8, 14],
        {"px_gap": 0, "spectra_gap": 0.0, "vote_gap": 0.0},
        {"cells_changed": 0, "cells_gap": 0, "cells_identical": 15,
         "cells_ref": 15}),
}

# A 3D configuration brought by new files alone: its source of work (a few
# seeded ellipsoids, never touching, in a (D, H, W) box of C channels), a
# program on the port's 3D labeling, and a plain reference.
TOY_SCENES = '''
import numpy as np
import torch


class Scenes:
    def __init__(self, traffic, layout, shape, seed):
        self.traffic, self.shape, self.seed = traffic, tuple(shape), seed
        self.n_ch = layout["n_channels"]

    def make(self, index, device):
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, index]))
        d, h, w = self.shape
        g = self.traffic["grid"]
        rz, rxy = self.traffic["radii"]
        zz, yy, xx = torch.meshgrid(*(torch.arange(
            n, dtype=torch.float32, device=device) for n in self.shape),
            indexing="ij")
        vol = torch.zeros(self.shape + (self.n_ch,), device=device)
        truth = torch.zeros(self.shape, dtype=torch.int32, device=device)
        spectra = rng.uniform(0.5, 1.0, (g * g, self.n_ch))
        jit = rng.uniform(-1.5, 1.5, (g * g, 3))
        for k in range(g * g):
            cz = d / 2 + jit[k, 0]
            cy = (k // g + 0.5) * h / g + jit[k, 1]
            cx = (k % g + 0.5) * w / g + jit[k, 2]
            inside = (((zz - cz) / rz) ** 2 + ((yy - cy) / rxy) ** 2
                      + ((xx - cx) / rxy) ** 2) <= 1
            vol[inside] += torch.as_tensor(spectra[k], dtype=torch.float32,
                                           device=device)
            truth[inside] = k + 1
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(2 ** 62)))
        vol += torch.rand(vol.shape, generator=gen, device=device) \\
            * self.traffic["noise"]
        return vol, truth, {"spectra": spectra}
'''

TOY_PROGRAM = '''
import torch

from hiprfish_tpu_torch.ops import labeling

KERNEL_ENTRIES = ()


class Program:
    def __init__(self, cfg):
        self.threshold = cfg["segmentation"]["threshold"]

    def step(self, vol):
        lab = labeling.label(vol.sum(-1) > self.threshold)
        _, inv = torch.unique(lab, return_inverse=True)
        n = int(inv.max())
        flat = vol.reshape(-1, vol.shape[-1])
        sums = torch.zeros((n + 1, flat.shape[1])).index_add_(
            0, inv.reshape(-1), flat)
        avgint = sums / torch.bincount(inv.reshape(-1))[:, None]
        prob, code = (avgint / avgint.sum(1, keepdim=True)).max(1)
        return {"n_cells": n, "labels": inv.to(torch.int32).numpy(),
                "avgint": avgint[1:].numpy(), "code": code[1:].numpy(),
                "prob": prob[1:].numpy()}

    def free(self):
        pass


def load(cfg, device, timings, reference=None):
    return Program(cfg)
'''

TOY_REFERENCE = '''
import torch

from plainref import labeling


def run(vol, clf, seg, max_cells, prec):
    lab = labeling.label(vol.sum(-1) > seg["threshold"])
    ids = [i for i in torch.unique(lab).tolist() if i]
    labels = torch.zeros_like(lab)
    avgint = torch.zeros((len(ids) + 1, vol.shape[-1]))
    for k, i in enumerate(ids, 1):
        labels[lab == i] = k
        avgint[k] = prec.round(vol[lab == i].mean(0))
    scores = avgint[1:] / avgint[1:].sum(1, keepdim=True)
    prob, code = scores.max(1)
    return {"n_cells": len(ids), "labels": labels, "avgint": avgint,
            "code": code, "prob": prob, "scores": scores}
'''

TOY_CONFIG = {
    "name": "toy-vol", "scenes": "toy_volume", "check_samples": 1,
    "fov": [64, 192, 192], "cpu_test": {"fov": [16, 48, 48]},
    "layout": {"name": "toy", "n_bits": 2, "n_channels": 3},
    "program": "toy_label", "max_cells": 64,
    "classifier": "ec10b-fov2000.clf.npz", "reference": "toy-vol.py",
    "segmentation": {"threshold": 0.5}}


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


def _checked_units(err: str) -> list:
    return json.loads(re.search(r"check: \S+ s, FOVs (\[.*\])", err)
                      .group(1))


def test_volume_config_by_new_files_alone(tmp_path):
    """A 3D configuration added by new files only, with its own source of
    work, a check of one sample and a CPU size: correct at --trace 0 and
    1 with exactly one result checked, not correct when half of its cells
    are left out, and no file that was there before touched."""
    root = bench_checkout.make(tmp_path)
    bench_dir = root / "benchmark"
    before = _digest(bench_dir)
    (bench_dir / "toy_volume.py").write_text(TOY_SCENES)
    (bench_dir / "programs" / "toy_label.py").write_text(TOY_PROGRAM)
    (bench_dir / "configs" / "toy-vol.py").write_text(TOY_REFERENCE)
    (bench_dir / "configs" / "toy-vol.json").write_text(
        json.dumps(TOY_CONFIG))
    traffic = {"grid": 3, "radii": [5, 5], "noise": 0.05}
    (bench_dir / "traffic" / "ellipsoids.json").write_text(
        json.dumps(traffic))
    (bench_dir / "limits" / "toy-vol.sweep.json").write_text(json.dumps(
        {"px_gap": 0, "spectra_gap": 1e-5, "vote_gap": 1e-5}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy-vol", "source": "a toy volume of the CPU tests",
        "file": "benchmark/configs/toy-vol.json", "reduced": [],
        "why": "a 3D unit of work from a source of its own"})
    bench["workloads"].append({
        "name": "toy-vol.sweep", "config": "toy-vol",
        "traffic": "ellipsoids", "chips": 1,
        "why": "a volume configuration added by files alone"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench_checkout.shrink(root)
    cfg = json.loads((bench_dir / "configs" / "toy-vol.json").read_text())
    assert cfg["fov"] == [16, 48, 48]
    assert json.loads((bench_dir / "traffic" / "ellipsoids.json")
                      .read_text()) == traffic
    for trace in (0, 1):
        rc, last, err = bench_checkout.run(root, "toy-vol.sweep",
                                           trace=trace, seconds=8)
        assert rc == 0, err[-3000:]
        assert last["correct"] is True, err[-3000:]
        assert len(_checked_units(err)) == 1
        assert "other numbers:" in err and '"cells_ref": 9' in err
    rc, last, err = bench_checkout.run(root, "toy-vol.sweep", "--fault",
                                       "drop_half", seconds=3)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["compared"]
    assert len(_checked_units(err)) == 1
    after = _digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload", sorted(BEFORE))
def test_default_sample_and_numbers_as_before(checkout, workload):
    """Without "scenes" and "check_samples" a cell renders, samples and
    compares the same units as before they could be named: under a
    counting clock, the same units attempted, the same four checked and
    the same numbers."""
    (seconds, seed), attempted, units, compared, other = BEFORE[workload]
    rc, last, err = bench_checkout.run(checkout, workload, seconds=seconds,
                                       seed=seed, counted=True)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True, err[-3000:]
    assert last["attempted"] == attempted
    assert _checked_units(err) == units
    assert {k: v["value"] for k, v in last["compared"].items()} == compared
    assert json.loads(re.search(r"other numbers: (.*)", err).group(1)) \
        == other


@pytest.mark.parametrize("workload", ["ms7b-confluent-sweep",
                                      "ec10b-confluent-sweep",
                                      "ms7b-sparse-sweep",
                                      "ec10b-sparse-sweep"])
def test_control_is_not_correct(checkout, workload):
    """The reference in bfloat16 in the program's place fails the
    comparison."""
    rc, last, err = bench_checkout.run(checkout, workload, "--program",
                                       "control", seconds=3)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["compared"]


@pytest.mark.parametrize("workload", ["ec10b-confluent-sweep",
                                      "ec10b-sparse-sweep"])
@pytest.mark.parametrize("fault", ["stale", "drop_half", "alter_call"])
def test_planted_fault_is_not_correct(checkout, fault, workload):
    """A step that answers with the previous FOV's result, one that leaves
    out half of the cells, and one call altered where it is made."""
    rc, last, err = bench_checkout.run(checkout, workload, "--fault", fault,
                                       seconds=3)
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
