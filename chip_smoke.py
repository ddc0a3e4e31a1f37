"""Drive the PyTorch port's stereo paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--trace-dir DIR]

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name and power limit; build the CUDA kernels from
     depthestimation_torch/csrc and report the build time;
  2. kernels against their plain PyTorch versions at 1080x1920,
     num_disp=128, bit exact, each timed on the card's own clock (CUDA
     events around one wrapper call enqueued behind a sleep kernel, so
     host time does not count; median of 7 after a warm-up): K1
     cost_volume (BT on an integer pair and on the fractional rectified
     pair, census), K2 hscan, K3 rowsweep in its four
     variants (down, up, diagonals down, diagonals up, with the storage
     types of sgbm_3way, hh4 and hh), and the remap of both images of a
     pair through the mild rig's maps, beside torch's grid_sample as a
     yardstick;
  3. end to end through StereoDepthEstimator(device="cuda").estimate_
     depth(), each path driven with the wrapper call and kernel launch
     counts set to 0 just before and read just after; a pair must call
     and launch exactly the kernels of its path, each as often as the
     path composes it:
     a. default: a seeded 1080x1920 RGB texture pair with a known 20 px
        shift; kernel-composed raw disparity against the plain-composed
        one on the card; the known shift on >= 95 % of pixels; the card
        against the CPU on a small pair; median ms per pair for the
        default (full postprocess) and the north-star (no speckle, WLS,
        fast mode) configs, and the device time of each stage of a pair;
     b. rectified: the mild rig of the JAX bench (hh4, full calibration)
        on a raw pair rendered so that rectification brings back a known
        shift, which must hold on >= 90 % of the pixels seen by both
        cameras; kernels against plain versions on the card; the card
        against the CPU on a small calibrated pair; ms per pair;
     c. hh (8 paths) and census (sgbm_3way) with the north-star flags:
        the known shift and ms per pair;
     d. streaming through StereoDepthEstimatorVideo(device="cuda"), each
        stream driven with the counts set to 0 just before and read just
        after, which must be exactly frames x the path's per-pair counts:
        A, the JAX bench's streaming_sustained_fps (40 uint8 1080p frames
        of the texture pair, brightness drifted +i, fast mode, hh4,
        no speckle, WLS, float16 depth), threaded and sequential, equal
        bit for bit, frames 0/20/39 equal to the float16 cast of
        StereoDepthEstimator's depth, the known shift on >= 95 %;
        B, the live example's smoother (temporal 0.4, hole filling, full
        postprocess) on 8 raw frames of the rectified rig, every frame
        equal to StereoPipeline.estimate_depth with the same temporal
        carry; C, 6 frames of 96x320 with temporal on, card against CPU
        (rtol 1e-5). For A and B: fps, latency and bytes per frame, and
        one steady frame's host time to enqueue against its device time
        (events behind a sleep kernel sized from the enqueue time) and a
        profiler trace's kernel time;
     e. the monocular net (plain PyTorch, no kernel of its own):
        MonoDepthModel.create("small", seed=0) (Depth-Anything-V2-Small's
        widths, random weights) at 1x518x518x3 on the card against the
        CPU with cuDNN's TF32 on and off (max abs err over max <= 2e-2 and
        1e-4), its FLOPs counted by torch's FlopCounterMode and its bound
        at the card's float32, TF32 and bf16 rates, ms and fps from CUDA
        events and from the host clock, the profiler's kernel count and
        the host's enqueue ms; MonocularDepthEstimator("small",
        device="cuda") on a seeded 1080x1920 RGB image through its array
        path (the model on the card; 518x924 out, finite, >= 0;
        preprocessing on the card equal to the CPU's bit for bit; ms per
        image end to end; one predict_async's kernel count, kernel ms and
        host enqueue ms); base and large timed at 518x518;
  4. one JSON line {"kernels": [...]}: per kernel the wrapper calls and
     kernel launches counted in phase 3 in one pair of the path named, ms
     per call, its bound, and the loss per pair, calls x (ms - bound_ms);
  5. one JSON line {"streams": {...}} with phase 3d's numbers, one JSON
     line {"mono": {...}} with phase 3e's beside the card's name and power
     limit, the card's name and power limit, then the last line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or depthestimation_tpu.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

H, W, D, SHIFT = 1080, 1920, 128, 20
# H100 SXM peaks (NVIDIA data sheet): memory rate and the 32-bit rate
# outside the tensor cores, against which every kernel's bound is taken.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
NORTH_STAR = dict(speckle_window_size=0, wls_filter=True)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def texture(h, w, seed):
    """(h, w) uint8 smoothed multi-scale random texture."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((h, w), np.float32)
    for scale in (1, 2, 4, 8):
        low = rng.normal(0, 1, (h // scale + 1, w // scale + 1)).astype(np.float32)
        tex += np.kron(low, np.ones((scale, scale), np.float32))[:h, :w]
    tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)) / 3.0
    return ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255.0).astype(np.uint8)


def texture_pair(h, w, shift, seed):
    """RGB uint8 pair: a texture, and the same texture moved so that
    left[x] == right[x - shift]."""
    tex = texture(h, w + shift, seed)
    left, right = tex[:, :w], tex[:, shift:]
    return (np.repeat(left[..., None], 3, -1).copy(),
            np.repeat(right[..., None], 3, -1).copy())


def mild_rig(h, w):
    """configure_sgbm keys of the JAX bench's rectified configuration
    (bench.py:377-391): fx = 1000 at 1920 columns (scaled with the width),
    centred K, a 0.25 degree roll between the cameras, light radial
    distortion, baseline 0.12 m."""
    fx = 1000.0 * w / 1920
    k = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    th = np.deg2rad(0.25)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]])
    dist = np.array([-0.01, 0.002, 0.0, 0.0, 0.0])
    return dict(cam_matrix_L=k, cam_matrix_R=k, image_width=w, image_height=h,
                dist_coeff_L=dist, dist_coeff_R=dist, rotation=rot,
                focal_length=fx, baseline=0.12)


def render_raw_pair(cfg, shift, seed):
    """RGB uint8 raw pair of a calibrated rig whose rectified images are a
    texture S and S moved by `shift` (rectified disparity = shift). Each
    raw pixel is undistorted, rotated by R1/R2 and projected with P1/P2
    into the rectified frame, and S is sampled there."""
    from depthestimation_torch import calib
    from depthestimation_torch.ops import remap

    c = cfg.calib
    h, w = c.image_height, c.image_width
    r1, r2, p1, p2, _ = calib.stereo_rectify(
        c.K_l(), c.dist_l(), c.K_r(), c.dist_r(), (w, h), c.R(),
        c.T(cfg.baseline), alpha=1.0)
    margin = 64
    tex = torch.tensor(texture(h + 2 * margin, w + shift + 2 * margin, seed),
                       dtype=torch.float32)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([u, v], -1)
    raws = []
    for k, dist, rk, pk, off in ((c.K_l(), c.dist_l(), r1, p1, 0),
                                 (c.K_r(), c.dist_r(), r2, p2, shift)):
        und = calib._undistort_points(pts, k, dist)
        dirs = np.concatenate([und, np.ones((h, w, 1))], -1) @ rk.T
        ru = pk[0, 0] * dirs[..., 0] / dirs[..., 2] + pk[0, 2]
        rv = pk[1, 1] * dirs[..., 1] / dirs[..., 2] + pk[1, 2]
        img = remap.remap_bilinear_plain(
            tex, torch.tensor((ru + off + margin).astype(np.float32)),
            torch.tensor((rv + margin).astype(np.float32)))
        gray = np.clip(np.round(img.numpy()), 0, 255).astype(np.uint8)
        raws.append(np.repeat(gray[..., None], 3, -1))
    return raws


def seen_by_both(maps_x, maps_y, shift, num_disp, pad=3):
    """Mask over the cropped disparity: the rectified left pixel and its
    match `shift` columns left in the right image both sample inside
    their raw images (pad pixels from the edge)."""
    mx, my = maps_x.cpu().numpy(), maps_y.cpu().numpy()
    h, w = mx.shape[1:]
    inside = ((mx >= pad) & (mx <= w - 1 - pad) & (my >= pad)
              & (my <= h - 1 - pad))
    return inside[0][:, num_disp:] & inside[1][:, num_disp - shift:w - shift]


# Cycles of the card's sleep kernel run before each timed call (~2 ms at
# the H100's clock): the host enqueues the call while the card sleeps, so
# the events bracket the call's device time and not the host's time to
# enqueue it, which for a wrapper (Python, checks, ctypes) is tens of
# microseconds, as much as a small kernel.
SLEEP_CYCLES = 4_000_000


def time_ms(fn, runs=7) -> float:
    """Median device milliseconds of fn() on the card, after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, runs=5) -> float:
    """Median wall-clock milliseconds of fn(), which ends in a host copy
    (and so a synchronisation), after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max().item())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def hold_exact(name, got, want, errs):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"plain {want.dtype}{tuple(want.shape)}")
    errs[name] = max_abs_err(got, want)
    log(f"[2] {name}: {got.dtype} {tuple(got.shape)} max_abs_err {errs[name]}")
    if errs[name] != 0:
        raise AssertionError(f"{name} disagrees with its plain version")


def counted():
    """{kernel: (wrapper calls, launches)} since the last reset, for every
    kernel called or launched."""
    from depthestimation_torch.ops import cuda_sgm

    return {k: (cuda_sgm.CALLS[k], n)
            for k, n in cuda_sgm.LAUNCHES.items() if n or cuda_sgm.CALLS[k]}


def drive(est, counts_of, path, expected):
    """One estimate_depth() with the wrapper call and launch counts set to
    0 just before and read just after. Fails unless the pair called and
    launched exactly the kernels in `expected` ({name: (calls, launches)})
    and no other; returns (disparity, depth)."""
    from depthestimation_torch.ops import cuda_sgm

    cuda_sgm.reset_launches()
    out = est.estimate_depth()
    torch.cuda.synchronize()
    counts = counted()
    log(f"[3{path[0]}] (calls, launches) in one {path} pair: {counts}")
    if counts != expected:
        raise AssertionError(f"the {path} path made (calls, launches) "
                             f"{counts}, expected {expected}")
    counts_of[path] = counts
    return out


def check_output(disp, depth, shape, tag):
    if disp.shape != shape or depth.shape != shape:
        raise AssertionError(f"{tag}: output shapes {disp.shape}, {depth.shape}")
    if not np.isfinite(disp).all():
        raise AssertionError(f"{tag}: non-finite disparity")


def k3_passes(c, swe, cfg, cfg4, cfg8):
    """K3's four passes on the inputs each mode gives them, as
    {name: (acc, cfg, dxs, reverse, out_dtype)}: sgbm_3way's downward pass,
    hh4's upward pass, and hh's diagonal passes down and up (the storage
    types of each mode)."""
    from depthestimation_torch.ops import cuda_sgm

    acc4, acc8 = cuda_sgm._acc_dtype(cfg4), cuda_sgm._acc_dtype(cfg8)
    return {
        "rowsweep": (swe, cfg, (0,), False, cuda_sgm._final_dtype(cfg)),
        "rowsweep_up": (cuda_sgm.rowsweep(c, swe, cfg4, (0,), False, acc4),
                        cfg4, (0,), True, cuda_sgm._final_dtype(cfg4)),
        "rowsweep_diag": (swe, cfg8, (0, 1, -1), False, acc8),
        "rowsweep_diag_up": (
            cuda_sgm.rowsweep(c, swe, cfg8, (0, 1, -1), False, acc8),
            cfg8, (0, -1, 1), True, cuda_sgm._final_dtype(cfg8)),
    }


# ---- 3d. streaming ----
# Stream A: the JAX bench's streaming_sustained_fps (bench.py:455-498).
STREAM_A = dict(num_disp=D, sgbm_mode="hh4", speckle_window_size=0,
                wls_filter=True, focal_length=1000.0, baseline=0.12)
# Stream B: the live example's smoother (examples/example_stereo_live.py:
# 55-62), full postprocess, on the mild calibrated rig.
LIVE = dict(hole_filling=True, temporal_alpha=0.4)


def drifted(pair, n):
    """n frame pairs of an RGB uint8 pair, brightness drifted by +i on
    frame i (bench.py:470-471)."""
    return tuple([np.clip(img.astype(np.int16) + i, 0, 255).astype(np.uint8)
                  for i in range(n)] for img in pair)


def run_stream(frames, sgbm, expected, tag, **kw):
    """Stream frames through StereoDepthEstimatorVideo(device="cuda") with
    the call and launch counts set to 0 just before and read just after;
    fails unless every frame came out, none failed, and the stream called
    and launched exactly `expected` ({name: (calls, launches)}). Returns
    (yielded depth maps, metrics summary)."""
    from depthestimation_torch import StereoDepthEstimatorVideo
    from depthestimation_torch.ops import cuda_sgm

    vid = StereoDepthEstimatorVideo(*frames, target_fps=0, device="cuda", **kw)
    vid.configure_sgbm(**sgbm)
    cuda_sgm.reset_launches()
    out = list(vid.estimate_depth())
    torch.cuda.synchronize()
    counts = counted()
    summary = vid.metrics.summary()
    log(f"[3d] {tag}: {summary}; (calls, launches) over the stream: {counts}")
    if len(out) != len(frames[0]) or summary["frames_failed"] != 0:
        raise AssertionError(f"{tag}: {len(out)} of {len(frames[0])} frames, "
                             f"{summary['frames_failed']} failed")
    if counts != expected:
        raise AssertionError(f"{tag}: (calls, launches) {counts}, expected {expected}")
    summary["launches"] = {k: n for k, (_, n) in counts.items()}
    return out, summary


def sleep_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per ms on this card, from 10 M cycles."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def host_device_split(fn, cycles_per_ms, trace_dir=None, runs=3):
    """Host ms to enqueue fn() against the card's ms to run it.

    - host_ms: wall time of the enqueue from an idle card;
    - host_behind_sleep_ms: the same behind a sleep kernel 3x longer than
      the slowest host_ms plus 20 ms, so the card is kept busy;
    - device_events_ms: CUDA events around fn() enqueued behind that
      sleep;
    - kernel_ms / span_ms / kernels: the sum of fn()'s kernel times, the
      time from its first kernel's start to its last one's end, and its
      kernel count, from a torch.profiler trace of one call enqueued from
      an idle card (0 if the profiler saw no device activity), written
      as a Chrome trace under trace_dir when one is given.
    Medians of `runs`, after two warm-up calls. A stream's launch queue is
    finite: when fn() makes more launches than it holds, the host waits
    for the card once it is full, so host_behind_sleep_ms then runs into
    the sleep, and device_events_ms includes the card waiting for the
    host after the sleep; kernel_ms does not. card_idle_share, 1 -
    kernel_ms / host_ms, is the share of the time the card would idle
    waiting for the host if calls were enqueued back to back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from depthestimation_torch import profiling

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    idle, busy, dev = [], [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        idle.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    sleep_ms = 3 * max(idle) + 20
    sleep = int(sleep_ms * cycles_per_ms)
    for _ in range(runs):
        torch.cuda._sleep(sleep)
        t0 = time.perf_counter()
        fn()
        busy.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    tracer = (profiling.trace(trace_dir) if trace_dir else
              profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    with tracer as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0
    split = {"host_ms": float(np.median(idle)),
             "host_behind_sleep_ms": float(np.median(busy)),
             "device_events_ms": float(np.median(dev)),
             "kernel_ms": kernel_us / 1e3, "span_ms": span_us / 1e3,
             "kernels": len(kernels), "sleep_ms": sleep_ms}
    # The profiler slows the host's launches, so the idle share inside
    # the traced call reads higher than card_idle_share.
    split["card_idle_share"] = (max(0.0, 1.0 - split["kernel_ms"] / split["host_ms"])
                                if kernels else None)
    split["traced_idle_share"] = (1.0 - kernel_us / span_us) if span_us else None
    return split


def frame_split(vid, left, right, cycles_per_ms, tag, trace_dir):
    """host_device_split of one steady-state frame of the facade: compute,
    depth cast and read-back copies, as StereoDepthEstimatorVideo enqueues
    them, on a pair already staged on the card; its trace goes to
    trace_dir/trace_<tag> when a trace_dir is given."""

    def frame():
        disp, depth = vid.core.estimate_depth_async(left, right)
        if depth is not None and vid.depth_dtype == "float16":
            depth = depth.to(torch.float16)
        return vid._readback(disp, depth)

    split = host_device_split(frame, cycles_per_ms,
                              trace_dir and f"{trace_dir}/trace_{tag}")
    log(f"[3d] {tag} one steady frame: {split}")
    return split


def phase_streaming(raw_pair, cycles_per_ms, trace_dir):
    """Streams A, B and C through StereoDepthEstimatorVideo; returns the
    numbers to print."""
    from depthestimation_torch import StereoDepthEstimator, StereoDepthEstimatorVideo
    from depthestimation_torch.io.threaded import PairStager
    from depthestimation_torch.metrics import frame_metrics_from_stats
    from depthestimation_torch.pipeline import StereoPipeline

    result = {}

    # -- A: 40 uint8 1080p frames, fast mode, north-star flags, hh4 --
    n_a = 40
    frames_a = drifted(texture_pair(H, W, SHIFT, seed=0), n_a)
    expect_a = {"cost_volume": (n_a, n_a), "hscan": (n_a, 2 * n_a),
                "rowsweep": (n_a, n_a), "rowsweep_up": (n_a, n_a)}
    kw_a = dict(fast_mode=True, depth_dtype="float16")
    out_a, sum_a = run_stream(frames_a, STREAM_A, expect_a, "A threaded",
                              use_threading=True, **kw_a)
    seq_a, sum_seq = run_stream(frames_a, STREAM_A, expect_a, "A sequential",
                                use_threading=False, **kw_a)
    for i, (t, s) in enumerate(zip(out_a, seq_a)):
        if t.dtype != np.float16 or t.shape != (H, W - D) or not np.array_equal(
                t.view(np.uint16), s.view(np.uint16)):
            raise AssertionError(f"A: threaded frame {i} differs from sequential")
    single = StereoDepthEstimator(device="cuda")
    single.configure_sgbm(**STREAM_A)
    single.core.fast_mode = True
    for i in (0, 20, n_a - 1):
        single.left_source, single.right_source = frames_a[0][i], frames_a[1][i]
        want = single.estimate_depth()[1].astype(np.float16)
        if not np.array_equal(out_a[i].view(np.uint16), want.view(np.uint16)):
            raise AssertionError(f"A: frame {i} differs from the single-pair path")
        disp = 1000.0 * 0.12 / out_a[i].astype(np.float32)
        hit = float((np.abs(disp - SHIFT) <= 1.0).mean())
        log(f"[3d] A frame {i}: == single-pair float16 depth (bit for bit); "
            f"known shift on {hit:.4%} of pixels")
        if hit < 0.95:
            raise AssertionError(f"A: frame {i} known shift on < 95 % of pixels")
    log("[3d] A: threaded == sequential on all 40 frames (bit for bit)")
    vid = StereoDepthEstimatorVideo(target_fps=0, device="cuda", **kw_a)
    vid.configure_sgbm(**STREAM_A)
    stager = PairStager("cuda")
    staged = stager.adopt(*stager.stage((frames_a[0][1], frames_a[1][1])))
    # The host's per-frame metrics work on the thread that enqueues
    # (float16 -> float32 copy, percentile of the depths).
    stats = torch.tensor([1.0, 19.0, 21.0, 20.0])
    metrics_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        frame_metrics_from_stats(stats, out_a[5])
        metrics_ms.append((time.perf_counter() - t0) * 1e3)
    result["A"] = dict(sum_a, sequential_fps=sum_seq["throughput_fps"],
                       metrics_host_ms=float(np.median(metrics_ms)),
                       **frame_split(vid, *staged, cycles_per_ms, "A", trace_dir))
    del out_a, seq_a, frames_a

    # -- B: the live smoother on 8 raw frames of the calibrated rig --
    n_b = 8
    rig = dict(num_disp=D, sgbm_mode="hh4", **LIVE, **mild_rig(H, W))
    frames_b = drifted(raw_pair, n_b)
    expect_b = {"remap": (n_b, n_b), "cost_volume": (n_b, n_b),
                "hscan": (n_b, 2 * n_b), "rowsweep": (n_b, n_b),
                "rowsweep_up": (n_b, n_b)}
    out_b, sum_b = run_stream(frames_b, rig, expect_b, "B threaded",
                              use_threading=True)
    ref = StereoPipeline(device="cuda")
    ref.configure(**rig)
    for i, (l, r) in enumerate(zip(*frames_b)):
        want = ref.estimate_depth(l, r)[1]
        if out_b[i].dtype != np.float32 or not np.array_equal(
                out_b[i].view(np.uint32), want.view(np.uint32)):
            raise AssertionError(f"B: frame {i} differs from StereoPipeline's")
    log(f"[3d] B: all {n_b} frames == StereoPipeline.estimate_depth with the "
        "temporal carry (float32, bit for bit)")
    vid = StereoDepthEstimatorVideo(target_fps=0, device="cuda")
    vid.configure_sgbm(**rig)
    staged = stager.adopt(*stager.stage((frames_b[0][1], frames_b[1][1])))
    result["B"] = dict(sum_b, **frame_split(vid, *staged, cycles_per_ms, "B", trace_dir))
    del out_b, frames_b

    # -- C: card against CPU, 6 small frames, temporal on --
    frames_c = drifted(texture_pair(96, 320, 9, seed=3), 6)
    outs = []
    for device in ("cuda", "cpu"):
        v = StereoDepthEstimatorVideo(*frames_c, target_fps=0, device=device)
        v.configure_sgbm(num_disp=32, focal_length=500.0, baseline=0.1, **LIVE)
        outs.append(list(v.estimate_depth()))
    if len(outs[0]) != 6 or len(outs[1]) != 6:
        raise AssertionError("C: frames lost")
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    log("[3d] C: 6 frames of 96x320, temporal on: card == CPU (depth rtol 1e-5)")
    result["C"] = {"frames": 6, "rtol": 1e-5}
    return result


# Peak rates of one H100 SXM for the mono net's bound (NVIDIA data sheet,
# dense): float32 outside the tensor cores, TF32 and bf16 tensor cores.
MONO_PEAKS = {"fp32": OPS_PER_S, "tf32": 495e12, "bf16": 989e12}
# Card against CPU, max abs diff over the CPU output's max abs value: float32
# sums in other orders; TF32 keeps 10 mantissa bits (2^-11 a rounded
# operand) on every convolution, the patch embedding's carried through the
# blocks and about twenty more in the head.
MONO_TOL = {False: 1e-4, True: 2e-2}


def mono_forward_numbers(net, x, cycles_per_ms, tag):
    """Median ms and fps of one forward from CUDA events (behind a sleep
    sized from the enqueue) and from the host clock, with the profiler's
    kernel count, kernel ms and the host's enqueue ms."""

    def forward():
        with torch.inference_mode():
            return net(x)

    split = host_device_split(forward, cycles_per_ms, runs=5)

    def forward_synced():
        forward()
        torch.cuda.synchronize()

    wall = host_ms(forward_synced, runs=11)
    out = {"events_ms": split["device_events_ms"],
           "events_fps": 1e3 / split["device_events_ms"],
           "host_clock_ms": wall, "host_clock_fps": 1e3 / wall,
           "kernels": split["kernels"], "kernel_ms": split["kernel_ms"],
           "host_enqueue_ms": split["host_ms"],
           "card_idle_share": split["card_idle_share"]}
    log(f"[3e] {tag}: {out}")
    return out


def phase_mono(cycles_per_ms, smi):
    """The monocular path: `small` at 518x518 against the CPU with TF32 on
    and off, timed; the facade on a 1080p image; `base` and `large` timed
    once. Returns the numbers to print."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    from depthestimation_torch import MonocularDepthEstimator
    from depthestimation_torch.models.mono import MonoDepthModel, preprocess_image

    dev = torch.device("cuda")
    tf32_default = torch.backends.cudnn.allow_tf32
    result = {"card": smi, "input": [1, 518, 518, 3]}

    # -- small, the full widths of Depth-Anything-V2-Small, seeded init --
    cpu_model = MonoDepthModel.create("small", seed=0, image_size=518, device="cpu")
    x = torch.rand(1, 518, 518, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = cpu_model.net(x)
    model = MonoDepthModel(net=copy.deepcopy(cpu_model.net)).to_device(dev)
    xc = x.to(dev)
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        model.net(xc)
    flops = counter.get_total_flops()
    counts = counter.get_flop_counts()
    result["small_flops"] = {
        "total": flops, "vit": sum(counts["MonoDepthNet.backbone"].values()),
        "dpt": sum(counts["MonoDepthNet.head"].values())}
    result["small_bound_ms"] = {k: flops / v * 1e3 for k, v in MONO_PEAKS.items()}
    log(f"[3e] small at 518x518: {flops / 1e9:.2f} GFLOP (matmuls and convolutions); "
        f"bound ms {result['small_bound_ms']}")
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            got = model.net(xc).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        log(f"[3e] small, cuDNN TF32 {tf32}: card vs CPU max abs err / max "
            f"{err:.3e} (tolerance {MONO_TOL[tf32]})")
        if not err <= MONO_TOL[tf32]:
            raise AssertionError(f"mono small: card differs from the CPU, TF32 {tf32}")
        key = "small_tf32" if tf32 else "small_fp32"
        result[key] = dict(mono_forward_numbers(model.net, xc, cycles_per_ms, key),
                           rel_err_vs_cpu=err, tolerance=MONO_TOL[tf32])
    torch.backends.cudnn.allow_tf32 = tf32_default

    # -- the facade, a seeded 1080x1920 RGB image through its array path --
    est = MonocularDepthEstimator("small", device="cuda")
    if est.model.device != dev or not next(est.model.net.parameters()).is_cuda:
        raise AssertionError("mono facade: the model is not on the card")
    img = np.random.default_rng(7).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    pre = preprocess_image(img, device=dev)
    if pre.device.type != "cuda" or not torch.equal(pre.cpu(), preprocess_image(img)):
        raise AssertionError("mono: the card's preprocessing differs from the CPU's")
    log("[3e] preprocess 1080x1920 -> 518x924: card == CPU (bit for bit)")
    depth = est._estimate_image(img)
    if depth.shape != (518, 924) or not np.isfinite(depth).all() or (depth < 0).any():
        raise AssertionError(f"mono facade: depth {depth.shape} not finite and >= 0")
    facade_ms = host_ms(lambda: est._estimate_image(img))
    split = host_device_split(lambda: est.model.predict_async(img), cycles_per_ms)
    result["facade_1080p"] = {"out_shape": list(depth.shape), "ms_per_image": facade_ms,
                              "cudnn_tf32": tf32_default,
                              "predict_async": {k: split[k] for k in (
                                  "kernels", "kernel_ms", "host_ms", "card_idle_share")}}
    log(f"[3e] facade 1080x1920 -> {depth.shape}: finite, >= 0; "
        f"{facade_ms:.2f} ms per image end to end; one predict_async (upload, "
        f"preprocessing, forward): {split}")
    del est, model, cpu_model

    # -- base and large at 518x518, random weights, no CPU comparison --
    for size in ("base", "large"):
        net = MonoDepthModel.create(size, seed=0, device=dev).net
        with FlopCounterMode(display=False) as counter, torch.inference_mode():
            out = net(xc)
        if out.shape != (1, 518, 518) or not torch.isfinite(out).all():
            raise AssertionError(f"mono {size}: output {tuple(out.shape)} not finite")
        result[size] = dict(mono_forward_numbers(net, xc, cycles_per_ms, size),
                            flops=counter.get_total_flops(), cudnn_tf32=tf32_default)
        del net, out
        torch.cuda.empty_cache()
    return result


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace-dir", default=None,
                        help="write phase 3d's profiler traces (Chrome JSON) here")
    trace_dir = parser.parse_args().trace_dir
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    import torch.nn.functional as F

    from depthestimation_torch import StereoDepthEstimator, SGMConfig
    from depthestimation_torch import pipeline
    from depthestimation_torch.calib import RectificationCache
    from depthestimation_torch.ops import (cuda_build, cuda_sgm, filters,
                                           remap, wta)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] device: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_build.load_library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    entry = "?"
    for line in cuda_build.build_log().splitlines():
        m = re.search(r"entry function '\w*?\d([a-z][a-z_]*_kernel)"
                      r"(I(?:L[a-z]\d+E|[a-z])*)?", line)
        if m:
            entry = m.group(1) + (m.group(2) or "")
        elif "registers" in line or "spill" in line:
            log(f"    ptxas {entry}:", line.strip())

    # ---- 2. kernels against their plain versions, 1080x1920x128 ----
    cfg = SGMConfig(num_disp=D)
    cfg4 = SGMConfig(num_disp=D, sgbm_mode="hh4")
    cfg8 = SGMConfig(num_disp=D, sgbm_mode="hh")
    cfgc = SGMConfig(num_disp=D, cost="census")
    left_rgb, right_rgb = texture_pair(H, W, SHIFT, seed=0)
    gl = torch.tensor(left_rgb[..., 0], dtype=torch.float32, device=dev)
    gr = torch.tensor(right_rgb[..., 0], dtype=torch.float32, device=dev)
    rig_cfg = SGMConfig().updated(**mild_rig(H, W))
    maps_x, maps_y = RectificationCache().device_maps(
        rig_cfg.calib, rig_cfg.baseline, 1.0, dev)
    pair = torch.stack([gl, gr])

    errs = {}
    rect = remap.remap_bilinear(pair, maps_x, maps_y)
    hold_exact("remap", rect, remap.remap_bilinear_plain(pair, maps_x, maps_y), errs)
    fl, fr = rect[0], rect[1]
    c = cuda_sgm.cost_volume(gl, gr, cfg)
    hold_exact("cost_volume", c, cuda_sgm.cost_volume_plain(gl, gr, cfg), errs)
    c_frac = cuda_sgm.cost_volume(fl, fr, cfg)
    hold_exact("cost_volume_fractional", c_frac,
               cuda_sgm.cost_volume_plain(fl, fr, cfg), errs)
    del c_frac
    cc = cuda_sgm.cost_volume(gl, gr, cfgc)
    hold_exact("cost_volume_census", cc, cuda_sgm.cost_volume_plain(gl, gr, cfgc), errs)
    swe = cuda_sgm.hscan(c, cfg)
    hold_exact("hscan", swe, cuda_sgm.hscan_plain(c, cfg), errs)

    k3 = k3_passes(c, swe, cfg, cfg4, cfg8)
    k3_out = {}
    for name, (acc, kcfg, dxs, rev, dt) in k3.items():
        k3_out[name] = cuda_sgm.rowsweep(c, acc, kcfg, dxs, rev, dt)
        hold_exact(name, k3_out[name],
                   cuda_sgm.rowsweep_plain(c, acc, kcfg, dxs, rev, dt), errs)
    torch.cuda.synchronize()

    timed = {
        "remap": (lambda: remap.remap_bilinear(pair, maps_x, maps_y),
                  lambda: remap.remap_bilinear_plain(pair, maps_x, maps_y)),
        "cost_volume": (lambda: cuda_sgm.cost_volume(gl, gr, cfg),
                        lambda: cuda_sgm.cost_volume_plain(gl, gr, cfg)),
        "cost_volume_census": (lambda: cuda_sgm.cost_volume(gl, gr, cfgc),
                               lambda: cuda_sgm.cost_volume_plain(gl, gr, cfgc)),
        "hscan": (lambda: cuda_sgm.hscan(c, cfg),
                  lambda: cuda_sgm.hscan_plain(c, cfg)),
    }
    for name, (acc, kcfg, dxs, rev, dt) in k3.items():
        timed[name] = (
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: cuda_sgm.rowsweep(c, a, k, x, r, t),
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: cuda_sgm.rowsweep_plain(c, a, k, x, r, t))
    ms, plain_ms = {}, {}
    for name, (kern, plain) in timed.items():
        ms[name] = time_ms(kern)
        plain_ms[name] = time_ms(plain, runs=5)
        log(f"[2] {name}: {ms[name]:.4f} ms, plain {plain_ms[name]:.2f} ms")

    # Yardstick for the remap (never on the path): grid_sample, bilinear,
    # zeros outside, align_corners=True maps -1..1 onto pixels 0..W-1.
    grid = torch.stack([maps_x / (W - 1) * 2 - 1, maps_y / (H - 1) * 2 - 1], -1)
    library = {"remap": time_ms(lambda: F.grid_sample(
        pair[:, None], grid, mode="bilinear", padding_mode="zeros",
        align_corners=True))}
    lib_out = F.grid_sample(pair[:, None], grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)[:, 0]
    log(f"[2] remap yardstick grid_sample: {library['remap']:.4f} ms, "
        f"max |diff| to the kernel {max_abs_err(lib_out, rect):.3g}")
    del lib_out, grid

    # Least time for the same work: each input read once, each output
    # written once, or the operations at the 32-bit rate, whichever is
    # larger. Operations per (y, x, d): K1 BT the pixel cost once (10)
    # plus a separable running box sum (4), census XOR + popcount (2) plus
    # the box sum; K2 two scan steps (9 each) plus the sum; K3 one scan
    # step plus the sum per direction. Remap: ~17 per output pixel.
    n = H * W * D
    acc_b = swe.element_size()
    work = {
        "cost_volume": (2 * H * W * 4 + n * 2, n * 14),
        "cost_volume_census": (2 * H * W * 4 + n * 2, n * 6),
        "hscan": (n * (2 + acc_b), n * 19),
        "remap": (2 * H * W * 4 * 4, 2 * H * W * 17),
    }
    for name, (acc, _, dxs, _, _) in k3.items():
        work[name] = (n * (2 + acc.element_size() + k3_out[name].element_size()),
                      n * 10 * len(dxs))
    del k3, k3_out, cc

    # ---- 3a. default path through the user's entry point ----
    counts_of = {}
    est = StereoDepthEstimator(device="cuda")
    est.left_source, est.right_source = left_rgb, right_rgb
    est.configure_sgbm(num_disp=D, focal_length=1000.0, baseline=0.1)
    disp, depth = drive(est, counts_of, "a default",
                        {"cost_volume": (1, 1), "hscan": (1, 2),
                         "rowsweep": (1, 1)})
    check_output(disp, depth, (H, W - D), "default")
    hit = float((np.abs(disp - SHIFT) <= 1.0).mean())
    log(f"[3a] known {SHIFT} px shift recovered on {hit:.4%} of pixels; "
        f"depth at the shift {1000.0 * 0.1 / SHIFT:.4f} m, median "
        f"{float(np.median(depth[np.isfinite(depth)])):.4f} m")
    if hit < 0.95:
        raise AssertionError("known shift recovered on < 95 % of pixels")

    pl_, pr_ = est.core.prepare_rectified(left_rgb, right_rgb)
    raw_k = pipeline.raw_disparity(pl_, pr_, est.core.cfg)
    raw_p = pipeline.raw_disparity(pl_, pr_, est.core.cfg,
                                   matcher=cuda_sgm.sgm_disparity_plain)
    if not torch.equal(raw_k, raw_p):
        raise AssertionError("kernel raw disparity differs from plain-composed")
    log("[3a] raw disparity: kernels == plain versions on the card (exact)")

    small_l, small_r = texture_pair(64, 320, 9, seed=1)
    outs = []
    for device in ("cuda", "cpu"):
        e = StereoDepthEstimator(device=device)
        e.left_source, e.right_source = small_l, small_r
        e.configure_sgbm(num_disp=64, focal_length=500.0, baseline=0.1)
        outs.append(e.estimate_depth())
    if not np.array_equal(outs[0][0], outs[1][0]):
        raise AssertionError("64x320 pair: card disparity differs from CPU")
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5)
    log("[3a] 64x320 pair: card == CPU (disparity exact, depth rtol 1e-5)")

    e2e = {"default": host_ms(est.estimate_depth)}
    ns = StereoDepthEstimator(device="cuda")
    ns.left_source, ns.right_source = left_rgb, right_rgb
    ns.configure_sgbm(num_disp=D, focal_length=1000.0, baseline=0.1, **NORTH_STAR)
    ns.core.fast_mode = True
    e2e["north_star"] = host_ms(ns.estimate_depth)

    # Where a pair's device time goes, stage by stage (CUDA events).
    dcfg, ncfg = est.core.cfg, ns.core.cfg
    raw_m = cuda_sgm.sgm_disparity(pl_, pr_, dcfg)
    raw_ns = pipeline.raw_disparity(pl_, pr_, ncfg)
    s = cuda_sgm.rowsweep(c, swe, dcfg, (0,), False, cuda_sgm._final_dtype(dcfg))
    stages = {
        "matcher": lambda: cuda_sgm.sgm_disparity(pl_, pr_, dcfg),
        "wta_lr_tail": lambda: wta.wta_disparity(
            s, dcfg.min_disp, dcfg.uniqueness_ratio, dcfg.disp12_max_diff),
        "speckle_in_matcher": lambda: filters.filter_speckles(
            raw_m, float(dcfg.min_disp - 1), dcfg.speckle_window_size,
            float(dcfg.speckle_range)),
        "post_default_full": lambda: pipeline.postprocess_and_depth(
            raw_k, dcfg, guide=pl_),
        "post_northstar_fast_wls": lambda: pipeline.postprocess_and_depth(
            raw_ns, ncfg, fast_mode=True, guide=pl_),
    }
    # Each stage's host time to enqueue against its device time, the
    # sleep before it sized from the enqueue (a fixed 2 ms sleep is
    # shorter than most of these stages take to enqueue).
    cycles_per_ms = sleep_cycles_per_ms()
    split = {}
    for name, fn in stages.items():
        split[name] = host_device_split(fn, cycles_per_ms)
        log(f"[3a] stage {name}: {split[name]}")
    del s, c, swe, raw_m, raw_ns, raw_k, raw_p

    # ---- 3b. rectified path: the mild rig, hh4, full calibration ----
    rig = dict(num_disp=D, sgbm_mode="hh4", **NORTH_STAR, **mild_rig(H, W))
    raw_l, raw_r = render_raw_pair(SGMConfig().updated(**rig), SHIFT, seed=2)
    rest = StereoDepthEstimator(device="cuda")
    rest.left_source, rest.right_source = raw_l, raw_r
    rest.configure_sgbm(**rig)
    rest.core.fast_mode = True
    disp, depth = drive(rest, counts_of, "b rectified",
                        {"remap": (1, 1), "cost_volume": (1, 1),
                         "hscan": (1, 2), "rowsweep": (1, 1),
                         "rowsweep_up": (1, 1)})
    check_output(disp, depth, (H, W - D), "rectified")
    both = seen_by_both(maps_x, maps_y, SHIFT, D)
    hit = float((np.abs(disp - SHIFT) <= 1.0)[both].mean())
    log(f"[3b] rectification brought back the {SHIFT} px shift on {hit:.4%} "
        f"of the {both.mean():.2%} of pixels seen by both cameras")
    if hit < 0.90:
        raise AssertionError("rectified known shift on < 90 % of pixels")
    rl, rr = rest.core.left_rectified, rest.core.right_rectified
    raw_k = pipeline.raw_disparity(rl, rr, rest.core.cfg)
    raw_p = pipeline.raw_disparity(rl, rr, rest.core.cfg,
                                   matcher=cuda_sgm.sgm_disparity_plain)
    if not torch.equal(raw_k, raw_p):
        raise AssertionError("rectified: kernel raw disparity differs from "
                             "plain-composed")
    log("[3b] rectified raw disparity: kernels == plain versions on the card (exact)")
    del raw_k, raw_p

    small_rig = dict(num_disp=32, sgbm_mode="hh4", **NORTH_STAR, **mild_rig(64, 240))
    small_raw = render_raw_pair(SGMConfig().updated(**small_rig), 6, seed=3)
    outs = []
    for device in ("cuda", "cpu"):
        e = StereoDepthEstimator(device=device)
        e.left_source, e.right_source = small_raw
        e.configure_sgbm(**small_rig)
        e.core.fast_mode = True
        outs.append((*e.estimate_depth(), e.core.left_rectified.cpu()))
    if not torch.equal(outs[0][2], outs[1][2]):
        raise AssertionError("64x240 calibrated pair: card rectified image "
                             "differs from CPU")
    if not np.array_equal(outs[0][0], outs[1][0]):
        raise AssertionError("64x240 calibrated pair: card disparity differs from CPU")
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5)
    log("[3b] 64x240 calibrated pair: card == CPU (rectified images and "
        "disparity exact, depth rtol 1e-5)")
    e2e["rectified_hh4"] = host_ms(rest.estimate_depth)

    # ---- 3c. hh (8 paths) and census, north-star flags ----
    for path, kw, expected in (
            ("c hh", dict(sgbm_mode="hh"),
             {"cost_volume": (1, 1), "hscan": (1, 2),
              "rowsweep_diag": (1, 3), "rowsweep_diag_up": (1, 3)}),
            ("c census", dict(cost="census"),
             {"cost_volume_census": (1, 1), "hscan": (1, 2),
              "rowsweep": (1, 1)})):
        e = StereoDepthEstimator(device="cuda")
        e.left_source, e.right_source = left_rgb, right_rgb
        e.configure_sgbm(num_disp=D, focal_length=1000.0, baseline=0.1,
                         **NORTH_STAR, **kw)
        e.core.fast_mode = True
        disp, depth = drive(e, counts_of, path, expected)
        check_output(disp, depth, (H, W - D), path)
        hit = float((np.abs(disp - SHIFT) <= 1.0).mean())
        log(f"[3c] {path}: known shift on {hit:.4%} of pixels")
        if hit < 0.95:
            raise AssertionError(f"{path}: known shift on < 95 % of pixels")
        e2e[path.split()[1]] = host_ms(e.estimate_depth)
    log("[3] ms per 1080p pair: " + ", ".join(
        f"{k} {v:.2f}" for k, v in e2e.items()))

    # ---- 3d. streaming through StereoDepthEstimatorVideo ----
    streams = phase_streaming((raw_l, raw_r), cycles_per_ms, trace_dir)

    # ---- 3e. the monocular net and MonocularDepthEstimator ----
    mono_numbers = phase_mono(cycles_per_ms, smi)

    # ---- 4. kernels line ----
    # `calls` and `launches` are the counts of one pair of the path named,
    # read in phase 3; ms is per wrapper call, so a kernel's loss per pair
    # is calls x (ms - bound_ms).
    sgm_src = "depthestimation_torch/csrc/sgm_kernels.cu"
    kernel_rows = [
        # name, source, replaces, path whose pair counts its calls/launches
        ("cost_volume", sgm_src, "depthestimation_tpu/ops/pallas_sgm.py:188", "a default"),
        ("cost_volume_census", sgm_src, "depthestimation_tpu/ops/pallas_sgm.py:188",
         "c census"),
        ("hscan", sgm_src, "depthestimation_tpu/ops/pallas_sgm.py:501", "a default"),
        ("rowsweep", sgm_src, "depthestimation_tpu/ops/pallas_sgm.py:595", "a default"),
        ("rowsweep_up", sgm_src, "depthestimation_tpu/ops/pallas_sgm.py:595",
         "b rectified"),
        ("rowsweep_diag", sgm_src, "depthestimation_tpu/ops/pallas_sgm.py:595", "c hh"),
        ("rowsweep_diag_up", sgm_src, "depthestimation_tpu/ops/pallas_sgm.py:595",
         "c hh"),
        ("remap", "depthestimation_torch/csrc/remap_kernels.cu",
         "depthestimation_tpu/ops/remap.py:50", "b rectified"),
    ]
    kernels = []
    for name, source, replaces, path in kernel_rows:
        calls, launches = counts_of[path].get(name, (0, 0))
        nbytes, nops = work[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path.split()[1], "calls": calls,
            "launches": launches,
            "max_abs_err": errs[name], "exact": errs[name] == 0,
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library.get(name),
        }
        row["loss_ms"] = row["calls"] * (row["ms"] - row["bound_ms"])
        if name == "cost_volume":
            row["max_abs_err_fractional"] = errs["cost_volume_fractional"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"streams": streams, "stages": split}))
    print(json.dumps({"mono": mono_numbers}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
