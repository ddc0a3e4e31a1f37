"""The general traffic generator: a traffic file's "driver" names how its
items reach the program, and the rest of the file sets the sizes.

- pair_closed_loop: one caller keeps one StereoDepthEstimator and, item
  after item, sets its sources to the next pair of a pool of distinct
  seeded pairs and calls estimate_depth(). An item is handed to the
  program when the caller sets the sources, and done when the numpy
  disparity and depth are back.
- stream: one StereoDepthEstimatorVideo reads two endless source
  iterators that cycle pre-made drifting frames of one seeded scene, as
  fast as it goes. An item is handed when the program pulls its left
  frame (the pull is timestamped), and done when its depth map is
  yielded; time queued at the input counts.

Both warm up every shape in set-up (the first item captures the
program's CUDA graphs), then measure for `seconds`: the window ends when
the first item that completes at or past that time completes.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from dataclasses import dataclass, field

import torch

from . import scenes
from .check import Sampler


@dataclass
class Run:
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies: list = field(default_factory=list)  # s, of every item done in the window
    done_at: list = field(default_factory=list)  # host clock at each item's completion
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    samples: list = field(default_factory=list)
    inputs: dict = field(default_factory=dict)  # input key -> (left, right)
    outputs: tuple = ()


# What each driver's items hand back, in order.
OUTPUTS = {"pair_closed_loop": ("disparity", "depth"), "stream": ("depth",)}


def _peak(device) -> int:
    return torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0


def _failed_item():
    traceback.print_exc(file=sys.stderr)


def pair_inputs(config, traffic, seed, device):
    """The pool of distinct (left, right) pairs of a run."""
    h, w, d = config["height"], config["width"], config["sgm"]["num_disp"]
    return scenes.pair_pool(seed, traffic["pool"], h, w, d, traffic["scene"], device)


def stream_inputs(config, traffic, seed, device):
    """The frames a stream's sources cycle."""
    h, w, d = config["height"], config["width"], config["sgm"]["num_disp"]
    return scenes.drifting_frames(seed, traffic["frames"], h, w, d, traffic["drift"],
                                  traffic["scene"], device)


def pair_closed_loop(config, traffic, seed, seconds, device, profiler, spans, t_start):
    import depthestimation_torch as dt

    pool = pair_inputs(config, traffic, seed, device)
    n = len(pool)
    est = dt.StereoDepthEstimator(device=str(device))
    est.configure_sgbm(**config["sgm"])
    est.core.fast_mode = config["fast_mode"]

    def call(k):
        est.left_source, est.right_source = pool[k % n]
        return est.estimate_depth()

    warm = traffic["warmup_items"]
    for k in range(warm):
        call(k)
        if k == 0:
            profiler.open()
    spans.install_all()
    run = Run(inputs=dict(enumerate(pool)), outputs=OUTPUTS["pair_closed_loop"])
    sampler = Sampler(traffic["sample"], seed)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    profiler.start()
    done, t1 = 0, t0
    while t1 - t0 < seconds:
        k = warm + run.attempted
        run.attempted += 1
        a = time.perf_counter()
        try:
            out = call(k)
        except Exception:  # noqa: BLE001 -- a failed item is counted, the loop goes on
            _failed_item()
            run.failed += 1
            out = None
        t1 = time.perf_counter()
        if out is not None:
            run.latencies.append(t1 - a)
            run.done_at.append(t1)
            sampler.offer(done, k % n, out)
            done += 1
        profiler.item_done(done)
    run.window_s = t1 - t0
    run.peak_bytes = _peak(device)
    run.samples = sampler.items
    del est
    return run


def stream(config, traffic, seed, seconds, device, profiler, spans, t_start):
    import depthestimation_torch as dt

    frames = stream_inputs(config, traffic, seed, device)
    n = len(frames)
    pulls = []  # host clock of each left-frame pull, in order

    def source(side):
        k = 0
        while True:
            if side == 0:
                pulls.append(time.perf_counter())
            yield frames[k % n][side]
            k += 1

    vid = dt.StereoDepthEstimatorVideo(
        left_source=source(0), right_source=source(1), fast_mode=config["fast_mode"],
        use_threading=traffic["use_threading"], target_fps=traffic["target_fps"],
        drop_frames=traffic["drop_frames"], depth_dtype=config["stream_depth_dtype"],
        device=str(device))
    vid.configure_sgbm(**config["sgm"])
    gen = vid.estimate_depth()
    warm = traffic["warmup_items"]
    for k in range(warm):
        next(gen)
        if k == 0:
            profiler.open()
    failed0 = vid.metrics.frames_failed
    spans.install_all()
    run = Run(inputs=dict(enumerate(frames)), outputs=OUTPUTS["stream"])
    sampler = Sampler(traffic["sample"], seed)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    profiler.start()
    k, t1 = warm, t0
    try:
        while t1 - t0 < seconds:
            depth = next(gen)
            t1 = time.perf_counter()
            run.latencies.append(t1 - pulls[k])
            run.done_at.append(t1)
            sampler.offer(k - warm, k % n, (depth,))
            k += 1
            profiler.item_done(k - warm)
        run.window_s = t1 - t0
        run.peak_bytes = _peak(device)
        run.failed = vid.metrics.frames_failed - failed0
        run.attempted = k - warm + run.failed
    finally:
        gen.close()  # stops the input thread
        for t in threading.enumerate():
            if t.name == "stereo-input":
                t.join(timeout=60)
    run.samples = sampler.items
    del vid, gen
    return run


DRIVERS = {"pair_closed_loop": pair_closed_loop, "stream": stream}
INPUTS = {"pair_closed_loop": pair_inputs, "stream": stream_inputs}
