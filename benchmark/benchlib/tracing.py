"""The traced run's two sources: spans timed by the host's clock around
calls into the program, and a torch.profiler trace of a bounded stretch
of items at the start of the window.

A span wraps a callable of the program from outside, named
"module:qualified.name" (a function of a module, or a method of a class),
for the whole window; it also opens a profiler range of that name, so an
idle gap of the device can be put down to it. The profiler's events are
read in memory: device operations (kernels, copies, fills) with their
times, and the host's ranges on the thread that drives the program.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import time
from dataclasses import dataclass, field

import torch

TRACED = "bench.traced"


class Spans:
    """Host-clock spans of the program's callables: target -> [(t0, t1)]."""

    def __init__(self, targets=()):
        self.targets = list(targets)
        self.times: dict = {}
        self._undo = []

    def install_all(self):
        for target in self.targets:
            self.install(target)

    def install(self, target: str):
        if target in self.times:
            return
        mod_name, qual = target.split(":")
        owner = importlib.import_module(mod_name)
        *path, attr = qual.split(".")
        for part in path:
            owner = getattr(owner, part)
        orig = getattr(owner, attr)
        times = self.times.setdefault(target, [])

        @functools.wraps(orig)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(target):
                    return orig(*args, **kwargs)
            finally:
                times.append((t0, time.perf_counter()))

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def remove(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def after(self, t: float) -> dict:
        """target -> durations (s) of the spans that started at or after t."""
        return {k: [b - a for a, b in v if a >= t] for k, v in self.times.items()}


class Profiler:
    """torch.profiler over the first `items` items of the window; does
    nothing when items is 0. The profiler itself starts in set-up
    (open(), after the first item has captured the program's graphs), so
    that its own start-up stays out of the window; the traced stretch is
    a range from the window's start (start()) to the end of its
    `items`-th item."""

    def __init__(self, items: int, device: torch.device):
        self.items = items
        self.device = device
        self.prof = self._range = None
        self.stopped_at = None  # host clock when the traced stretch ended

    def open(self):
        if not self.items:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def start(self):
        if self.prof is not None:
            self._range = torch.profiler.record_function(TRACED)
            self._range.__enter__()

    def item_done(self, done: int):
        """Called with the number of items completed in the window."""
        if self._range is not None and done >= self.items:
            self.stop()

    def stop(self):
        """End the traced stretch (at the window's end at the latest)."""
        if self.prof is None or self.stopped_at is not None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.prof.__exit__(None, None, None)
        self.stopped_at = time.perf_counter()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class TraceView:
    """What a per-layer metric reads. Times in microseconds on the
    profiler's clock; spans in seconds."""

    config: dict
    device_ops: list = field(default_factory=list)  # (name, start, end) in the window
    window_us: float = 0.0
    busy_us: float = 0.0
    spans: dict = field(default_factory=dict)       # target -> durations after the trace
    span_items: int = 0                             # items completed after the trace
    latencies: list = field(default_factory=list)   # s, of those items
    breakdown: dict = field(default_factory=dict)


def read(profiler: Profiler, spans: Spans, run, config) -> TraceView:
    """What the per-layer metrics read of a traced run: the profiled
    stretch, and the spans and latencies of the items after it."""
    after = profiler.stopped_at or 0.0
    view = TraceView(config, spans=spans.after(after),
                     latencies=[x for x, t in zip(run.latencies, run.done_at) if t > after])
    view.span_items = len(view.latencies)
    if profiler.prof is None:
        return view
    from torch.autograd import DeviceType

    events = profiler.prof.events()
    window = next(e for e in events if e.name == TRACED)
    ws, we = window.time_range.start, window.time_range.end
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and b > ws and a < we:
                dev.append((e.name, max(a, ws), min(b, we)))
        elif e.thread == window.thread and e is not window:
            host.append((a, b, e.name))
    busy = _merge([(a, b) for _, a, b in dev])
    view.device_ops = dev
    view.window_us = we - ws
    view.busy_us = sum(b - a for a, b in busy)
    view.breakdown = {"device_ops": _top_ops(dev), "idle_gaps": _gaps(busy, ws, we, host)}
    return view


def _top_ops(dev, n=10):
    by_name = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], s] for name, s in top]


def _gaps(busy, ws, we, host, n=10):
    """Idle time of the device in the window, summed by the innermost
    host range open on the driving thread when each gap began."""
    host.sort()
    starts = [a for a, _, _ in host]
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    by_label = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = "(harness)"
        i = bisect.bisect_right(starts, a) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] > a:
                label = host[j][2]
                break
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], s] for name, s in top]
