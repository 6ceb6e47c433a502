"""Structured logging and per-stage timing (a copy of RunLog from
hiprfish_tpu/utils/logging.py), and a torch.profiler trace context.

Events are JSON lines (timestamp, stage, sample, seconds, extra) to stderr
and optionally a file; ``stage`` times a pipeline stage and ``summary``
totals the seconds and counts per stage of a run."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


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
