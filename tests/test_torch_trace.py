"""The port's spans (``hiprfish_tpu_torch.utils.logging.span``) on the
CPU: off without a profiler (no record, no profiler range, the same
outputs), on under ``torch.profiler`` (one ``step`` per call with its
stages in order, every flood's ``rounds`` equal to its loop's change
tests, each span a profiler range around its own operators), the
recorder's bound, and the benchmark's three readers of the records.
96 x 96 px FOVs; a few seconds."""

import collections
import importlib.util
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.ops import watershed as ws
from hiprfish_tpu_torch.pipeline import fused, fused_ecoli
from hiprfish_tpu_torch.utils import logging as ulog
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SHAPE = (96, 96)
MAX_CELLS = 64
# below MAX_CELLS, so that classify_capped reads n_cells back
CAP = 32
STAGES = {
    "7b": ["register", "denoise", "lpcv", "kmeans", "morphology", "markers",
           "watershed", "stats", "classify"],
    "10b": ["register", "kmeans", "small_holes", "morphology", "markers",
            "watershed", "stats", "classify"],
}
METRICS = ("torch_ops.flood_rounds_per_fov", "torch_ops.flood_ms_per_fov",
           "step.host_wait_ms_per_fov")


def _step_7b():
    fov = synthetic.make_fov(SEVEN_BIT, [1 + (i * 7) % 127 for i in range(9)],
                             shape=SHAPE, seed=1,
                             laser_shifts=[(0, 0), (2, -1), (0, 3), (-2, 0)],
                             cell_axes=(7.0, 12.0))
    arrays, static = fused.classifier_from_numpy(load_classifier(
        os.path.join(FIXTURES, "torch_port_clf_7b_127x50.npz")), "cpu")
    stack = tuple(torch.from_numpy(a) for a in fov["stack"])
    return lambda: fused.fov_step(stack, arrays, SegmentationConfig(),
                                  MAX_CELLS, static, classify_cap=CAP)


def _step_10b():
    fov = synthetic.make_fov(TEN_BIT, [(i * 37) % 1023 + 1 for i in range(9)],
                             shape=SHAPE, seed=2,
                             laser_shifts=synthetic.ECOLI_SHIFTS,
                             cell_axes=synthetic.ECOLI_CELL_AXES)
    arrays, static = fused.classifier_from_numpy(load_classifier(
        os.path.join(FIXTURES, "torch_port_clf_10b_1023x200.npz")), "cpu")
    stack = tuple(torch.from_numpy(a) for a in fov["stack"])
    return lambda: fused_ecoli.fov_step_ecoli(
        stack, arrays, SegmentationConfig(), MAX_CELLS, static,
        classify_cap=CAP)


def _no_range(*a, **k):
    raise AssertionError("record_function entered with no profiler")


class _CountReads:
    """Stands in for the flood driver's host_wait (``labeling``, whose
    driver runs every flood, the watershed's too): counts the change tests
    read inside each open span (by the span's id)."""

    def __init__(self):
        self.by_span = {}

    def __call__(self, read, value):
        stack = ulog.RECORDER.open_stack()
        if stack:
            sid = stack[-1][0]["id"]
            self.by_span[sid] = self.by_span.get(sid, 0) + 1
        return ulog.host_wait(read, value)


@pytest.fixture(scope="module", params=["7b", "10b"])
def runs(request):
    """(family, off result, on result, the on call's records, its
    profiler, change tests counted per span)."""
    step = {"7b": _step_7b, "10b": _step_10b}[request.param]()
    mp = pytest.MonkeyPatch()
    ulog.RECORDER.reset()
    try:
        mp.setattr(torch.autograd.profiler, "record_function", _no_range)
        off = step()
        assert ulog.RECORDER.snapshot() == []
        mp.undo()
        reads = _CountReads()
        mp.setattr(lab, "host_wait", reads)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = step()
        mp.undo()
        records = ulog.RECORDER.snapshot()
    finally:
        mp.undo()
        ulog.RECORDER.reset()
    return request.param, off, on, records, prof, reads.by_span


def test_spans_off_record_nothing_and_change_nothing(runs):
    _, off, on, _, _, _ = runs
    assert int(off.n_cells) > 0
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_one_step_with_its_stages_in_order(runs):
    family, _, _, records, _, _ = runs
    steps = [r for r in records if r["name"] == "step"]
    assert len(steps) == 1 and steps[0]["parent"] is None
    sid = steps[0]["id"]
    assert all(r["step"] == sid for r in records)
    children = [r["name"] for r in records if r["parent"] == sid]
    assert children == STAGES[family]
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = next(q for q in records if q["id"] == r["parent"])
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]


def test_flood_rounds_equal_their_change_tests(runs):
    family, _, _, records, _, by_span = runs
    floods = [r for r in records if r["name"].startswith("flood.")]
    names = {r["name"] for r in floods}
    assert names == {"flood.ccl", "flood.rank", "flood.reach",
                     "flood.watershed"}
    for r in floods:
        assert r["attrs"]["rounds"] == by_span[r["id"]] >= 1
        assert r["attrs"]["wait_ns"] > 0
        parent = next(q for q in records if q["id"] == r["parent"])
        # no flood span contains another
        assert not parent["name"].startswith("flood.")
    # every change test was read inside a flood span
    assert sum(by_span.values()) == sum(r["attrs"]["rounds"]
                                        for r in floods)
    stage = {r["name"]: r for r in records if r["parent"] is not None
             and not r["name"].startswith("flood.")}
    # the shift reads and the kept-cell index, and classify's n_cells read
    for name in ("register", "stats", "classify"):
        assert stage[name]["attrs"]["wait_ns"] > 0, name


def test_spans_are_profiler_ranges_around_their_operators(runs):
    _, _, _, records, prof, _ = runs
    events = prof.events()
    ranges = [e for e in events if e.name.startswith(ulog.SPAN_PREFIX)]
    assert collections.Counter(e.name for e in ranges) == collections.Counter(
        ulog.SPAN_PREFIX + r["name"] for r in records)
    for e in ranges:
        inner = [c for c in e.cpu_children if c.name.startswith("aten::")]
        nested = [c for c in e.cpu_children
                  if c.name.startswith(ulog.SPAN_PREFIX)]
        assert inner or nested, e.name
        for c in inner + nested:
            assert e.time_range.start <= c.time_range.start \
                <= c.time_range.end <= e.time_range.end
        if e.name == ulog.SPAN_PREFIX + "step":
            assert e.cpu_parent is None
        else:
            assert e.cpu_parent.name.startswith(ulog.SPAN_PREFIX)


@pytest.mark.parametrize("flood", ["ccl", "rank", "reach", "watershed"])
@pytest.mark.parametrize("cap", [None, 3])
def test_flood_rounds_on_a_known_line(flood, cap):
    """A line of 8 pixels with the scans capped at one step (max_run 2):
    a label, the reach or a watershed label moves one pixel a round, so
    the loop runs 7 rounds that change something and one that finds no
    change, or stops at its cap; the rank of the line's one component is
    in place from the start (one round)."""
    m = torch.zeros((5, 12), dtype=torch.bool)
    m[2, 1:9] = True
    iters = 512 if cap is None else cap
    ulog.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        if flood == "ccl":
            lab.label(m, 1, iters, 2)
        elif flood == "rank":
            from hiprfish_tpu_torch.ops import segstats
            segstats.rank_labels(lab.label(m, 1), 1, iters, 2)
        elif flood == "reach":
            seeds = torch.zeros_like(m)
            seeds[2, 1] = True
            lab.flood_reach(seeds, m, 1, iters, 2)
        else:
            markers = torch.zeros(m.shape, dtype=torch.int32)
            markers[2, 1] = 1
            ws.watershed(torch.zeros(m.shape), markers, m, 1, iters)
    recs = [r for r in ulog.RECORDER.snapshot()
            if r["name"] == "flood." + flood]
    ulog.RECORDER.reset()
    want = 1 if flood == "rank" else 8
    assert [r["attrs"]["rounds"] for r in recs] == [min(want, iters)]


def test_the_record_stays_bounded_and_snapshots_keep_it():
    ulog.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(300):
            with ulog.span("step"):
                with ulog.span("stats") as sp:
                    sp.set(rounds=1)
    snap = ulog.RECORDER.snapshot()
    steps = [r for r in snap if r["name"] == "step"]
    assert len(steps) == ulog.SPAN_STEPS == 256
    assert len(snap) == 2 * ulog.SPAN_STEPS
    # the newest steps are kept
    assert steps[-1]["id"] > steps[0]["id"]
    assert ulog.RECORDER.snapshot() == snap
    snap[0]["attrs"]["rounds"] = 99
    assert "rounds" not in ulog.RECORDER.snapshot()[0]["attrs"]
    ulog.RECORDER.reset()
    assert ulog.RECORDER.snapshot() == []


def test_host_wait_adds_to_the_innermost_span_only_when_recorded():
    ulog.RECORDER.reset()
    t = torch.ones(4)
    assert ulog.host_wait(int, t.sum()) == 4
    assert ulog.RECORDER.snapshot() == []
    with ulog.span("step") as sp:
        assert sp.set(rounds=1) is None
        assert ulog.host_wait(bool, t.any()) is True
    assert ulog.RECORDER.snapshot() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with ulog.span("step"):
            with ulog.span("stats"):
                ulog.host_wait(int, t.sum())
                ulog.host_wait(torch.Tensor.tolist, t)
    step, stats = ulog.RECORDER.snapshot()
    ulog.RECORDER.reset()
    assert "wait_ns" not in step["attrs"]
    assert stats["attrs"]["wait_ns"] > 0


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric(name):
    return _load(os.path.join(ROOT, "benchmark", "metrics", name + ".py"),
                 "metric_" + name.replace(".", "_"))


def test_profile_tool_reads_its_stage_table_from_the_spans(runs):
    family, _, _, records, prof, _ = runs
    tool = _load(os.path.join(ROOT, "tools", "profile_torch_fov.py"),
                 "profile_torch_fov")
    table = tool.span_table(prof, records)
    assert {"step/" + n for n in STAGES[family]} <= set(table)
    assert "step/markers/flood.ccl" in table
    step = table["step"]
    assert step["calls"] == 1
    assert step["host_ms"] == pytest.approx(sum(
        r["self_host_ms"] for r in table.values()))
    for k in ("rounds", "replays", "kernel"):
        assert sum(r[k] for r in table.values()) == sum(
            r["attrs"].get(k, 0) for r in records)
    assert sum(r["wait_ms"] for r in table.values()) == pytest.approx(sum(
        r["attrs"].get("wait_ns", 0) for r in records) / 1e6)
    # a CPU profile has no device activity
    assert all(r[k] == 0 for r in table.values()
               for k in ("device_ms", "launches", "syncs", "sync_ms",
                         "idle_ms"))


@pytest.mark.parametrize("name", METRICS)
def test_metric_is_none_without_the_recorder(name, monkeypatch):
    monkeypatch.delattr(ulog, "RECORDER")
    assert _metric(name).read({}) is None


class _Recorded:
    def __init__(self, records):
        self.records = records

    def snapshot(self):
        return [dict(r, attrs=dict(r["attrs"])) for r in self.records]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_a_recorded_step(name, runs, monkeypatch):
    _, _, _, records, _, _ = runs
    mod = _metric(name)
    monkeypatch.setattr(ulog, "RECORDER", _Recorded([]))
    assert mod.read({}) is None
    # a second step, and a flood outside any step, which no reader counts
    second = [dict(r, id=r["id"] + 10**6, step=r["step"] + 10**6,
                   parent=None if r["parent"] is None
                   else r["parent"] + 10**6) for r in records]
    stray = dict(records[-1], id=-1, parent=None, step=-1, name="flood.ccl",
                 attrs={"rounds": 1000, "wait_ns": 10**12})
    monkeypatch.setattr(ulog, "RECORDER",
                        _Recorded(records + [stray] + second))
    value = mod.read({})
    floods = [r for r in records if r["name"].startswith("flood.")]
    want = {
        "torch_ops.flood_rounds_per_fov":
            sum(r["attrs"]["rounds"] for r in floods),
        "torch_ops.flood_ms_per_fov":
            sum(r["end_ns"] - r["start_ns"] for r in floods) / 1e6,
        "step.host_wait_ms_per_fov":
            sum(r["attrs"].get("wait_ns", 0) for r in records) / 1e6,
    }[name]
    assert value == pytest.approx(want) and value > 0
