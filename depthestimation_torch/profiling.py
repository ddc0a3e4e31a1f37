"""Tracing / profiling hooks (counterpart of depthestimation_tpu/
profiling.py; SURVEY.md section 5: the reference has only wall-clock
prints, example_stereo.py:28-33). Named stage timing with a device fence,
torch.profiler traces of host and card, and named ranges for them.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["StageTimer", "trace", "annotate", "hard_sync"]


def hard_sync(tree):
    """Wait until the card has finished the work that produced the
    tensors in tree (a tensor, or a list/tuple/dict of them, nested):
    torch.cuda.synchronize on each CUDA device they lie on; nothing for
    tensors on the CPU, whose ops are synchronous. Returns tree."""
    devices = set()

    def visit(x):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


class _OutHolder:
    """Mutable slot a timed block stores its device outputs in."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = None


class StageTimer:
    """Accumulating named-stage wall timer with device sync.

    Usage:
        timer = StageTimer()
        with timer("cost_volume") as t:
            t.out = cost_fn(...)   # synced via hard_sync before stopping
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        """Times the block. The block should hand its device outputs to the
        yielded holder (``ctx.out = result``) so the timer waits for the
        card to finish them; otherwise only the host's time to enqueue the
        work is measured."""
        holder = _OutHolder()
        t0 = time.perf_counter()
        yield holder
        if self.sync and holder.out is not None:
            hard_sync(holder.out)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {
            name: {
                "total_ms": round(1000 * t, 2),
                "count": self.counts[name],
                "mean_ms": round(1000 * t / max(self.counts[name], 1), 2),
            }
            for name, t in sorted(self.totals.items())
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region with torch.profiler (host ops and, where a card is
    present, its kernels and copies) and write a Chrome trace,
    log_dir/trace.json (open in chrome://tracing or Perfetto). Yields the
    profiler, whose key_averages() sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range on the profiler's timeline (torch.profiler
    record_function)."""
    return torch.profiler.record_function(name)
