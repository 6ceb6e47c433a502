"""The traced run's instrumentation and its reading of the profiler's
events.

``OpSpans`` wraps the port functions that a program's ``KERNEL_ENTRIES``
name (for the 2D step: ``denoise.denoise_nl_means``,
``line_profile.lp_cv_enhance_2d``, ``segstats.label_stats`` and
``segstats.label_lookup``, which kernels B1-B4 implement) in a profiler
range each, and records the work of each call from its arguments while
the profiler runs (the label kernels' labelled pixels are counted on the
device in a range of its own, which every reading leaves out).
``Summary`` reads the profiled span, whole FOVs from the first to the
last: device kernels and copies, each attributed through its launch's
correlation id to the entry range it was launched in; host blocking
syncs; the device's busy intervals and idle gaps; what the host was
doing in each gap. Work the harness itself launches inside the span (a
FOV's rendering, in ``HARNESS_RANGE``) is left out of every count but the
device's busy time. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import importlib
import re

import numpy as np
import torch

from kernel_work import bound, kernel_work

OP_RANGE = "bench::op::"
COUNT_RANGE = "bench::count"
HARNESS_RANGE = "bench::harness"
MARK_ON = "bench::span_on"
MARK_OFF = "bench::span_off"
# host calls that block until the device has caught up
SYNC_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
    "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2"))


class OpSpans:
    """Profiler ranges and work records around a program's kernel
    entries: (module, function, op, work, count labelled pixels)."""

    def __init__(self, entries):
        self.active = False
        self.ops = tuple(dict.fromkeys(e[2] for e in entries))
        self.calls = []          # (op, kernel_work kwargs, labelled tensor)
        for mod_name, attr, op, work, labelled in entries:
            self._patch(importlib.import_module(mod_name), attr, op, work,
                        labelled)

    def _patch(self, module, attr, op, work, count_labelled):
        orig = getattr(module, attr)
        rf = torch.profiler.record_function
        spans = self

        def wrapped(*args, **kwargs):
            if not spans.active:
                return orig(*args, **kwargs)
            labelled = None
            if count_labelled:
                with rf(COUNT_RANGE):
                    labelled = torch.count_nonzero(args[0] > 0)
            spans.calls.append((op, work(*args, **kwargs), labelled))
            with rf(OP_RANGE + op):
                return orig(*args, **kwargs)

        wrapped.__wrapped__ = orig
        setattr(module, attr, wrapped)

    def take_bounds(self) -> dict:
        """{op: summed bound seconds} of the calls recorded since the last
        take, and forget them."""
        out = {op: 0.0 for op in self.ops}
        for op, work, labelled in self.calls:
            if labelled is not None:
                work = dict(work, labelled=int(labelled))
            ms, _ = bound(*kernel_work(op, **work))
            out[op] += ms / 1e3
        self.calls = []
        return out


def short_name(name: str) -> str:
    """A device op's name without its template arguments, with the
    functor or kernel it instantiates where the arguments name one."""
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "").strip()
    head = re.split(r"[<(]", base, maxsplit=1)[0].split("::")[-1]
    inner = base[len(base.split("<", 1)[0]):]
    found = re.findall(
        r"(\w+(?:Functor|_functor|_kernel_impl|_kernel_cuda|Op))", inner)
    if found:
        head += "_" + found[-1]
    return head.strip()[:80] or base[:80]


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of (n, 2) intervals as sorted disjoint intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = []
    s, e = int(iv[0, 0]), int(iv[0, 1])
    for a, b in iv[1:].tolist():
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.asarray(out, np.int64)


def _outermost_ops(cpu, tid):
    """The operators of thread ``tid`` that no other operator encloses."""
    ops = sorted((e for e in cpu if e.start_thread_id() == tid
                  and e.name().startswith("aten::")),
                 key=lambda e: (e.start_ns(), -e.duration_ns()))
    out, end = [], -1
    for e in ops:
        if e.start_ns() >= end:
            out.append(e)
            end = e.end_ns()
    return out


class Summary:
    """The profiled span, read from the profiler's events: ``reading()``
    is what the per-layer metrics read, ``breakdown()`` the top device
    ops and the longest idle gaps by what the host was doing."""

    def __init__(self, prof, n_fovs: int, ops, bounds_s: dict,
                 device_is_cuda: bool):
        events = prof.profiler.kineto_results.events()
        cpu, dev = [], []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append(e)
            else:
                cpu.append(e)
        ranges = [e for e in cpu if e.is_user_annotation()
                  and e.name().startswith("bench::")]
        on = [e for e in ranges if e.name() == MARK_ON]
        off = [e for e in ranges if e.name() == MARK_OFF]
        if not on or not off:
            raise RuntimeError("profiled span without its marks")
        self.span = (on[0].end_ns(), off[-1].start_ns())
        main_tid = on[0].start_thread_id()
        spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in ranges
                       if e.name().startswith((OP_RANGE, COUNT_RANGE,
                                               HARNESS_RANGE)))
        starts = [s for s, _, _ in spans]

        def range_of(t):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                return spans[i][2]
            return None

        if not device_is_cuda:
            # on the CPU the outermost operators stand in for device ops,
            # each launched by itself
            dev = _outermost_ops(cpu, main_tid)
            launch_t = {id(e): e.start_ns() for e in dev}
        else:
            # a device op's launch: the runtime call with its correlation
            # id, else the innermost operator or range around the launch
            launch = {e.correlation_id(): e.start_ns() for e in cpu
                      if e.name().startswith("cu")}
            outer = {e.correlation_id(): e.start_ns() for e in cpu
                     if not e.name().startswith("cu")
                     and e.device_index() != -1}
            launch_t = {id(e): launch.get(e.correlation_id(),
                                          outer.get(e.linked_correlation_id()))
                        for e in dev}
        lo, hi = self.span
        self.n_fovs = n_fovs
        self.launches = 0
        self.op_device_s = {op: 0.0 for op in ops}
        self.other_device_s = 0.0
        self.harness_device_s = 0.0
        self.device_ops = {}
        intervals = []
        for e in dev:
            t = launch_t[id(e)]
            if t is not None and not lo <= t <= hi:
                continue
            where = None if t is None else range_of(t)
            if where == COUNT_RANGE:
                continue
            s, d = e.start_ns(), e.duration_ns()
            intervals.append((s, s + d))
            if where == HARNESS_RANGE:
                self.harness_device_s += d / 1e9
                continue
            name = e.name()
            if not name.startswith(("Memcpy", "Memset")):
                self.launches += 1
            if where is not None and where.startswith(OP_RANGE):
                self.op_device_s[where[len(OP_RANGE):]] += d / 1e9
            else:
                self.other_device_s += d / 1e9
            key = short_name(name)
            self.device_ops[key] = self.device_ops.get(key, 0.0) + d / 1e9
        self.syncs = sum(1 for e in cpu if e.name() in SYNC_CALLS
                         and lo <= e.start_ns() <= hi
                         and range_of(e.start_ns()) not in (COUNT_RANGE,
                                                            HARNESS_RANGE))
        iv = _merge(np.asarray(intervals, np.int64).reshape(-1, 2))
        iv = np.clip(iv, lo, hi)
        iv = iv[iv[:, 1] > iv[:, 0]]
        self.busy_s = int((iv[:, 1] - iv[:, 0]).sum()) / 1e9
        edges = [lo] + iv.reshape(-1).tolist() + [hi]
        self.gaps = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]
        self.bounds_s = bounds_s
        self._host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                            if e.start_thread_id() == main_tid
                            and not e.name().startswith("bench::op::")
                            and e.name() not in (MARK_ON, MARK_OFF,
                                                 COUNT_RANGE))
        self._host_starts = np.asarray([h[0] for h in self._host], np.int64)

    def reading(self) -> dict:
        """What the per-layer metrics read."""
        return {"n_fovs": self.n_fovs, "busy_s": self.busy_s,
                "window_s": (self.span[1] - self.span[0]) / 1e9,
                "launches": self.launches, "syncs": self.syncs,
                "op_device_s": self.op_device_s, "op_bound_s": self.bounds_s,
                "other_device_s": self.other_device_s,
                "harness_device_s": self.harness_device_s}

    def host_activity(self) -> dict:
        """{what the host's main thread was doing: seconds} over the idle
        gaps: the innermost host event that covers a gap's middle, or
        'python_between_ops' where none does."""
        out = {}
        for a, b in self.gaps:
            t = (a + b) // 2
            i = int(np.searchsorted(self._host_starts, t, side="right")) - 1
            name = "python_between_ops"
            for j in range(i, max(i - 256, -1), -1):
                if self._host[j][1] >= t:
                    name = self._host[j][2]
                    break
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def breakdown(self) -> dict:
        def top(d):
            return sorted(([n, v] for n, v in d.items()),
                          key=lambda x: -x[1])[:10]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.host_activity())}
