"""Lightweight per-frame metrics (SURVEY.md section 5: the reference has
only ad-hoc prints — example_stereo.py:36-40, viz titles at
visualizations.py:102-106; this makes those stats a first-class struct).

Counterpart of depthestimation_tpu/metrics.py; frame_metrics_from_stats
takes the streaming facade's 4-element stats tensor.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from typing import List, Optional

import numpy as np
import torch

__all__ = ["FrameMetrics", "MetricsAggregator", "compute_frame_metrics",
           "frame_metrics_from_stats"]


@dataclass
class FrameMetrics:
    """Stats for one processed frame."""

    frame_index: int = 0
    latency_ms: float = 0.0
    fps: float = 0.0
    valid_fraction: float = 0.0  # disparity > 0 (reference validity rule)
    disp_min: float = 0.0  # over valid pixels
    disp_max: float = 0.0
    disp_mean: float = 0.0
    depth_invalid_pct: Optional[float] = None  # inf/nan/<=0 fraction, %
    depth_p50_m: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self))


def _with_depth_stats(m: FrameMetrics, depth) -> FrameMetrics:
    """Fill the depth fields of m from a host depth map (or leave them
    None without one)."""
    if depth is not None:
        # float16 depth (streaming depth_dtype='float16') would lose
        # precision in np.percentile's in-dtype interpolation; stats run
        # in float32.
        z = np.asarray(depth, dtype=np.float32)
        zvalid = np.isfinite(z) & (z > 0)
        m.depth_invalid_pct = float(100.0 * (~zvalid).mean())
        m.depth_p50_m = float(np.percentile(z[zvalid], 50)) if zvalid.any() else None
    return m


def compute_frame_metrics(disparity, depth=None, frame_index=0,
                          latency_ms=0.0) -> FrameMetrics:
    d = np.asarray(disparity)
    valid = d > 0
    m = FrameMetrics(
        frame_index=frame_index,
        latency_ms=latency_ms,
        fps=(1000.0 / latency_ms) if latency_ms > 0 else 0.0,
        valid_fraction=float(valid.mean()),
        disp_min=float(d[valid].min()) if valid.any() else 0.0,
        disp_max=float(d[valid].max()) if valid.any() else 0.0,
        disp_mean=float(d[valid].mean()) if valid.any() else 0.0,
    )
    return _with_depth_stats(m, depth)


def frame_metrics_from_stats(stats, depth=None, frame_index=0,
                             latency_ms=0.0) -> FrameMetrics:
    """FrameMetrics from a 4-vector of disparity stats computed on the
    device (valid_fraction, min, max, mean over valid pixels) -- the
    streaming path's 16-byte replacement for pulling the full disparity
    map to the host. A tensor is read through its one .cpu(): on the card
    that waits for the stream (a latency fence); the streaming facade
    passes a pinned host copy whose copy event it has already waited on."""
    if torch.is_tensor(stats):
        stats = stats.cpu()
    vf, dmin, dmax, dmean = (float(x) for x in np.asarray(stats, dtype=np.float32))
    if vf <= 0.0:
        dmin = dmax = dmean = 0.0
    m = FrameMetrics(
        frame_index=frame_index,
        latency_ms=latency_ms,
        fps=(1000.0 / latency_ms) if latency_ms > 0 else 0.0,
        valid_fraction=vf,
        disp_min=dmin,
        disp_max=dmax,
        disp_mean=dmean,
    )
    return _with_depth_stats(m, depth)


class MetricsAggregator:
    """Rolling aggregate over a stream (mean fps/latency, last frame)."""

    def __init__(self, window: int = 120):
        self.window = window
        self._lat: List[float] = []
        self.frames = 0
        self.frames_failed = 0  # frames skipped by per-frame error isolation
        self.last: Optional[FrameMetrics] = None
        self._t0 = time.time()
        # Host-link byte budget (SURVEY section 5): what a frame costs on
        # the host<->device link (PCIe here) is a first-class streaming
        # metric.
        self.bytes_in = 0
        self.bytes_out = 0

    def update(self, m: FrameMetrics):
        if self.frames == 0:
            # Start the throughput clock at the first completed frame so
            # that frame's jit-compile time doesn't poison the stat.
            self._t0 = time.time()
        self.frames += 1
        self.last = m
        self._lat.append(m.latency_ms)
        if len(self._lat) > self.window:
            self._lat.pop(0)

    def record_failure(self):
        """Count a frame dropped by the streaming runner's error isolation
        (decode or device failure; the stream itself continues)."""
        self.frames_failed += 1

    @property
    def mean_latency_ms(self) -> float:
        return float(np.mean(self._lat)) if self._lat else 0.0

    @property
    def steady_mean_latency_ms(self) -> float:
        """Mean frame latency excluding the first frame (whose latency is
        dominated by jit compilation on a cold cache)."""
        lat = self._lat[1:] if len(self._lat) > 1 else self._lat
        return float(np.mean(lat)) if lat else 0.0

    @property
    def throughput_fps(self) -> float:
        # The clock starts at the first frame's completion, so N frames
        # span N-1 inter-frame intervals. A single-frame stream has no
        # interval yet — report the latency-derived rate instead of 0.
        if self.frames <= 1:
            if self._lat and self._lat[-1] > 0:
                return 1000.0 / self._lat[-1]
            return 0.0
        dt = time.time() - self._t0
        return (self.frames - 1) / dt if dt > 0 else 0.0

    def record_bytes(self, bytes_in: int = 0, bytes_out: int = 0):
        """Account host->device / device->host traffic for one frame."""
        self.bytes_in += int(bytes_in)
        self.bytes_out += int(bytes_out)

    def summary(self) -> dict:
        s = {
            "frames": self.frames,
            "frames_failed": self.frames_failed,
            "mean_latency_ms": round(self.mean_latency_ms, 2),
            "steady_mean_latency_ms": round(self.steady_mean_latency_ms, 2),
            "throughput_fps": round(self.throughput_fps, 2),
        }
        if self.frames and (self.bytes_in or self.bytes_out):
            s["bytes_per_frame_in"] = self.bytes_in // self.frames
            s["bytes_per_frame_out"] = self.bytes_out // self.frames
        return s
