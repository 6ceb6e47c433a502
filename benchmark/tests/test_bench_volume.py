"""The 3D configuration ``bio7b-vol2020`` and its cell
``bio7b-volume-sweep``, on the CPU at the configuration's ``cpu_test``
size (a 144 x 96 x 40 volume of 8 cells from 2 x 4 tiles, swept in tiles
of 45 planes whose boundaries cut through cells): the source of volumes
(seeded, every index new, 9,408 cells at full size), the plain reference
against the port's ``volume_step`` (every compared number 0), its 3D
phase correlation finding the planted tile shifts, the cell correct
untraced and traced, the control and two planted faults not correct, and
the cell's four metric readers. One test, marked ``cuda``, compares the
program with the reference at full size on the card:

    python -m pytest benchmark/tests/test_bench_volume.py -m cuda
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_checkout

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import compare  # noqa: E402
import volume7b_scenes  # noqa: E402
from plainref import precision, register3d  # noqa: E402
from plainref.classify import Classifier  # noqa: E402

CELL = "bio7b-volume-sweep"
CONFIG = "bio7b-vol2020"
SEEDS = (2**31 + 2301, 2**32 + 77)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(full: bool = False) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    if not full:
        cfg.update(cfg["cpu_test"])
    cfg["classifier_path"] = str(BENCH / "configs" / cfg["classifier"])
    return cfg


def _traffic() -> dict:
    return json.loads((BENCH / "traffic" / "volume7b.json").read_text())


def _scenes(cfg: dict, seed: int):
    return volume7b_scenes.Scenes(_traffic(), cfg["layout"], cfg["fov"],
                                  seed)


def _program_against_reference(cfg: dict, seed: int, device) -> dict:
    """The compared numbers of the program's result on volume 0 of
    ``seed`` against the reference's (float32) on the same volume."""
    program = _load(BENCH / "programs" / "volume_step.py",
                    "program_volume_step").load(cfg, device, {})
    vols = _scenes(cfg, seed)
    host = program.step(vols.make(0, device)[0])
    program.free()
    reference = _load(BENCH / "configs" / f"{CONFIG}.py", "reference_vol")
    ref = reference.run(vols.make(0, device)[0],
                        Classifier(cfg["classifier_path"], device),
                        cfg["segmentation"], cfg["max_cells"],
                        precision.FLOAT32)
    n = ref["n_cells"]
    ref = {"n_cells": n, "labels": ref["labels"].cpu().numpy(),
           "avgint": ref["avgint"][1:n + 1].cpu().numpy(),
           "code": ref["code"].cpu().numpy(),
           "prob": ref["prob"].cpu().numpy(),
           "scores": ref["scores"].cpu().numpy()}
    return compare.numbers(host, ref)


def test_volumes_are_seeded_and_new_at_every_index():
    cfg = _config()
    a, b = _scenes(cfg, SEEDS[0]), _scenes(cfg, SEEDS[0])
    sa, truth, plan = a.make(3, "cpu")
    sb, _, _ = b.make(3, "cpu")
    assert truth["n_cells"] == 8 and len(truth["codes"]) == 8
    assert 1 <= truth["codes"].min() and truth["codes"].max() <= 127
    assert [t.shape for t in sa.tiles] == [(102, 69, 40)] * 8
    assert plan["tile_shifts"][0] == (0, 0, 0)
    assert all(max(map(abs, s)) <= 3 for s in plan["tile_shifts"])
    for x, y in zip(sa.tiles, sb.tiles):
        assert torch.equal(x, y)
    assert torch.equal(sa.slabs(4, 2), sb.slabs(4, 2))
    assert sa.slabs(4, 2).dtype == torch.bfloat16
    assert sa.slabs(4, 2).shape == (63, 2, 144, 96)
    sc, _, plan_c = a.make(4, "cpu")
    assert plan_c["salt"] != plan["salt"]
    assert not torch.equal(sa.tiles[0], sc.tiles[0])
    full = _config(full=True)
    vol = volume7b_scenes.Volume(_traffic(), full["fov"], plan["salt"], 127)
    assert vol.grid == (56, 56, 3) and vol.n_cells == 9408


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_equals_the_port(seed):
    got = _program_against_reference(_config(), seed, torch.device("cpu"))
    assert got["cells_ref"] == got["cells_identical"] == 8
    assert {k: got[k] for k in compare.NAMES} == dict.fromkeys(
        compare.NAMES, 0)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_phase_correlation_finds_the_planted_tile_shifts(index):
    """Each tile against its neighbour (the row above's first, else its
    left one) is moved by the difference of their planted shifts,
    negated."""
    stack, _, plan = _scenes(_config(), SEEDS[1]).make(index, "cpu")
    planted = np.asarray(plan["tile_shifts"])
    gy, gx = stack.grid
    want = [(0, 0, 0)]
    for k in range(1, gy * gx):
        nb = k - gx if k % gx == 0 else k - 1
        want.append(tuple(int(v) for v in planted[nb] - planted[k]))
    assert any(s != (0, 0, 0) for s in want)
    assert register3d.tile_shifts(stack.tiles, stack.grid,
                                  stack.overlap) == want


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return bench_checkout.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct(checkout, trace):
    rc, last, err = bench_checkout.run(checkout, CELL, trace=trace,
                                       seconds=16, counted=True)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True, err[-3000:]
    assert '"cells_ref": 8' in err
    if trace:
        for name in ("volume.tile_sweep_ms", "volume.merge_ms",
                     "torch_ops.flood_rounds_per_fov",
                     "step.host_wait_ms_per_fov"):
            assert last["metrics"][name]["value"] > 0


@pytest.mark.parametrize("how", [("--program", "control"),
                                 ("--fault", "drop_half"),
                                 ("--fault", "alter_call")])
def test_control_and_faults_are_not_correct(checkout, how):
    rc, last, err = bench_checkout.run(checkout, CELL, *how, seconds=8,
                                       counted=True)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["compared"]


class _Recorded:
    def __init__(self, records):
        self.records = records

    def snapshot(self):
        return [dict(r, attrs=dict(r["attrs"])) for r in self.records]


def _span(i, name, parent, step, start, end, **attrs):
    return {"id": i, "name": name, "parent": parent, "step": step,
            "start_ns": start, "end_ns": end, "attrs": attrs}


# two recorded volume steps, and a tile sweep outside any step
RECORDS = [
    _span(0, "step", None, 0, 0, 9_000_000),
    _span(1, "tiles", 0, 0, 1_000_000, 5_000_000, tiles=6),
    _span(2, "merge", 0, 0, 5_000_000, 5_500_000, pairs=9, unions=4),
    _span(3, "step", None, 3, 10_000_000, 19_000_000),
    _span(4, "tiles", 3, 3, 11_000_000, 13_000_000, tiles=6),
    _span(5, "merge", 3, 3, 13_000_000, 14_500_000, pairs=9, unions=4),
    _span(6, "tiles", None, 6, 20_000_000, 90_000_000),
]


@pytest.mark.parametrize("name,want", [("volume.tile_sweep_ms", 3.0),
                                       ("volume.merge_ms", 1.0)])
def test_span_readers(name, want, monkeypatch):
    from hiprfish_tpu_torch.utils import logging as ulog

    mod = _load(BENCH / "metrics" / f"{name}.py", "metric_span")
    monkeypatch.setattr(ulog, "RECORDER", _Recorded(RECORDS))
    assert mod.read({}) == pytest.approx(want)
    monkeypatch.setattr(ulog, "RECORDER", _Recorded(RECORDS[-1:]))
    assert mod.read({}) is None
    monkeypatch.delattr(ulog, "RECORDER")
    assert mod.read({}) is None


@pytest.mark.parametrize("name,op", [
    ("kernels.lpcv3d_roofline_share", "lpcv3d"),
    ("kernels.stats_cm_roofline_share", "stats_cm")])
def test_roofline_readers(name, op):
    mod = _load(BENCH / "metrics" / f"{name}.py", "metric_roofline")
    trace = {"op_device_s": {op: 0.2, "label_stats": 1.0},
             "op_bound_s": {op: 0.05, "label_stats": 1.0}}
    assert mod.read(trace) == pytest.approx(25.0)
    assert mod.read({"op_device_s": {"label_stats": 1.0},
                     "op_bound_s": {"label_stats": 1.0}}) is None


@pytest.mark.cuda
def test_program_against_reference_at_full_size():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false here)")
    from hiprfish_tpu_torch.kernels import _build

    _build.build()
    cfg = _config(full=True)
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    got = _program_against_reference(cfg, 2**31 + 2323,
                                     torch.device("cuda"))
    print(json.dumps(got))
    assert got["cells_ref"] == 9408
    for name, limit in limits.items():
        assert got[name] <= limit, (name, got)
