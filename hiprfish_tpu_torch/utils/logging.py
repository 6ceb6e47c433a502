"""Structured logging and per-stage timing (a copy of RunLog from
hiprfish_tpu/utils/logging.py), a torch.profiler trace context, and the
port's spans.

Events are JSON lines (timestamp, stage, sample, seconds, extra) to stderr
and optionally a file; ``stage`` times a pipeline stage and ``summary``
totals the seconds and counts per stage of a run; ``stage_timer`` adds
synchronised stage seconds to a dict.

``span(name, **attrs)`` marks a stage of the port (the FOV steps' stages,
each fixpoint flood). It is on exactly while a torch profiler records:
then it is the profiler range ``hiprfish::<name>``, on the clock the
profiler shares with the card's activity, and a record in ``RECORDER``
(name, host start and end in ``time.perf_counter_ns``, parent, the id of
its root span, attributes). Off, it costs one boolean test. ``host_wait``
makes a host read of a device value and, inside a recorded span, adds
the host's blocked time to that span's ``wait_ns``."""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time

import torch.autograd.profiler as _tap


class RunLog:
    def __init__(self, path: str | None = None, stream=None):
        self.path = path
        self.stream = stream if stream is not None else sys.stderr
        self.events = []

    def event(self, stage: str, **kwargs):
        rec = {"t": round(time.time(), 3), "stage": stage, **kwargs}
        self.events.append(rec)
        line = json.dumps(rec)
        print(line, file=self.stream)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")

    @contextlib.contextmanager
    def stage(self, name: str, **kwargs):
        t0 = time.time()
        try:
            yield
        finally:
            self.event(name, seconds=round(time.time() - t0, 3), **kwargs)

    def summary(self):
        totals = {}
        for e in self.events:
            if "seconds" in e:
                totals.setdefault(e["stage"], [0.0, 0])
                totals[e["stage"]][0] += e["seconds"]
                totals[e["stage"]][1] += 1
        return {
            k: {"total_s": round(v[0], 3), "count": v[1]}
            for k, v in totals.items()
        }


def stage_timer(timings, device):
    """lap(name): add the seconds since the previous lap (or since this
    call) to ``timings[name]``, after synchronising the card when
    ``device`` is CUDA; with ``timings`` None it does nothing."""
    stamp = [time.time()]

    def lap(name):
        if timings is not None:
            if device.type == "cuda":
                import torch

                torch.cuda.synchronize(device)
            now = time.time()
            timings[name] = timings.get(name, 0.0) + now - stamp[0]
            stamp[0] = now

    return lap


@contextlib.contextmanager
def profile_trace(logdir: str, device="cuda"):
    """torch.profiler over the block, with the card's activity when
    ``device`` is a CUDA device; writes the Chrome trace
    ``logdir/trace.json`` when the block ends. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


SPAN_PREFIX = "hiprfish::"
# the root spans (FOV steps) whose records the recorder keeps
SPAN_STEPS = 256


class SpanRecorder:
    """The records of the spans opened while a profiler recorded, kept
    for the last SPAN_STEPS root spans (a FOV step is one root; its
    stages and floods share its id as ``step``). Each record is a dict:
    ``id``, ``name``, ``parent`` (the enclosing span's id, None at a
    root), ``step``, ``start_ns``, ``end_ns``, ``attrs``."""

    def __init__(self):
        self._groups = collections.deque(maxlen=SPAN_STEPS)
        self._ids = itertools.count()
        self._local = threading.local()

    def open_stack(self) -> list:
        """This thread's open spans, innermost last: (record, group)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, attrs: dict) -> dict:
        """A new record, pushed on this thread's open spans: a child of
        the innermost one, else a new root (which may push the oldest
        root's records out)."""
        stack = self.open_stack()
        rec = {"id": next(self._ids), "name": name, "parent": None,
               "step": None, "start_ns": None, "end_ns": None,
               "attrs": attrs}
        if stack:
            parent, group = stack[-1]
            rec["parent"], rec["step"] = parent["id"], parent["step"]
        else:
            rec["step"] = rec["id"]
            group = []
            self._groups.append(group)
        group.append(rec)
        stack.append((rec, group))
        return rec

    def close(self) -> None:
        self.open_stack().pop()

    def snapshot(self) -> list:
        """Copies of the kept records, oldest root first; the recorder
        keeps them."""
        return [dict(r, attrs=dict(r["attrs"]))
                for group in list(self._groups) for r in list(group)]

    def reset(self) -> None:
        self._groups.clear()


RECORDER = SpanRecorder()


class _Span:
    """A recorded span and its profiler range."""

    __slots__ = ("_name", "_attrs", "_record", "_range")

    def __init__(self, name: str, attrs: dict):
        self._name, self._attrs = name, attrs

    def set(self, **attrs) -> None:
        self._attrs.update(attrs)

    def __enter__(self):
        self._record = RECORDER.open(self._name, self._attrs)
        self._range = _tap.record_function(SPAN_PREFIX + self._name)
        self._range.__enter__()
        self._record["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._record["end_ns"] = time.perf_counter_ns()
        RECORDER.close()
        self._range.__exit__(exc_type, exc, tb)
        return False


class _Off:
    """The span while no profiler records: it does nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager marking a stage of the port; ``set(**attrs)`` on
    what it yields adds attributes (a flood's ``rounds``). Recorded only
    while a torch profiler records (``utils.logging.profile_trace``, or
    any ``torch.profiler.profile``)."""
    if not _tap._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def host_wait(read, value):
    """``read(value)``: a host read of a device value, such as a fixpoint
    round's change test (``bool``), which blocks until the card has
    caught up. Inside a recorded span the host's blocked time adds to the
    innermost span's ``wait_ns``."""
    if not _tap._is_profiler_enabled:
        return read(value)
    stack = RECORDER.open_stack()
    if not stack:
        return read(value)
    t0 = time.perf_counter_ns()
    out = read(value)
    attrs = stack[-1][0]["attrs"]
    attrs["wait_ns"] = attrs.get("wait_ns", 0) + time.perf_counter_ns() - t0
    return out
