"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--trace-dir DIR] [--tensor-parallel]

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
     yardstick; the WTA stage on the default's aggregated volume S (one
     launch: argmin, uniqueness, subpixel and the LR check); the speckle
     filter on the matcher's raw disparity (speckle
     off) at a pair's two calls (window 50 on the map, window 100 on the
     crop); above 256 disparities (WIDE_HOLDS: 64x400x272 and
     24x1100x1024), K1 BT and census, K2 and K3's four passes through
     their wide variants, bit exact;
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
     f. the mono training step (models/train.py) over an NCCL group of one
        rank, mesh (1, 1, 1): `small` (seeded, Depth-Anything-V2-Small's
        widths) on seeded 4x518x518x3 images and targets in [0.5, 2];
        one make_train_step against the plain step on the CPU with TF32
        off (TRAIN_TOL); TRAIN_STEPS steps through the step's CUDA graph,
        each against an eager step (step.eager) from the same copied
        state, TF32 off: every step's loss, gradients and weights at
        TRAIN_TOL, AdamW capturable with its step count on the card
        reading TRAIN_STEPS after the replays; TRAIN_STEPS steps with
        finite, falling losses; the graph's first-use numbers; ms per
        step (events and host clock), images/s, peak memory, the step's
        kernel count, host enqueue ms and the card's idle share, graphed
        and eager side by side;
     g. the parallel layer (parallel/shard.py) on that mesh: batch_pipeline
        over 4 of phase 3's integer 1080p pairs (sgbm_3way, BT, fast mode),
        its first call (eager, then the capture of its CUDA graph) and a
        replay, each driven with the counts set to 0 just before and read
        just after, which must be exactly K1 1, K2 1 call / 2 launches,
        K3 1 a frame, every frame equal bit for bit to raw_disparity +
        postprocess_and_depth and the replay to run.eager; ms per batch,
        host enqueue, kernel ms and idle share, eager against graphed;
        disp_sharded_sgm equal bit for bit to the kernels' matcher; the
        tile function at 4 tiles with DEFAULT_HALO run tile by tile
        against the whole image (hh4; mismatch at the seams and overall
        < 0.5 %); predict_sharded equal to the net's forward, a replay
        within MONO_GRAPH_TOL of its eager run, both timed; with several
        GPUs, batch_pipeline and disp_sharded_sgm again with one process
        per GPU, and the frames' rows over every GPU (the halo exchange
        and the gather in the graph), replays equal to eager; with four,
        the tensor-parallel check, its graphed steps and predict held to
        eager on every rank;
     h. the user-facing surface: a synthetic 2964x1988 pair (a scene of
        ndisp 330, its nearest plane at 264 px) written as PNG with its
        calib.txt (examples/example_stereo.py's rig, ndisp 280) and decoded
        back bit for bit; examples.stereo on it at downscale 0.5 without
        calib.txt (994x1482, D = 144) and with it (1988x2964, D = 144, the
        remap), and at 1.0 without it (1988x2964, D = 288), each run with
        the counts set to 0 just before and read just after (exactly K1 1,
        K2 1 / 2, K3 1, as hscan_wide and rowsweep_wide at D = 288, and
        remap 1 with calib.txt), its disparity equal bit for bit to
        StereoDepthEstimator's on the decoded arrays, K1/K2/K3 (at D = 288
        all four K3 passes) and the remap equal to their plain versions at
        that shape and timed, the valid share, the MAE against the scene's
        ground truth, ms per pair, first-call ms, the graph's pool bytes
        and the peak of allocated memory; at D = 288 the raw valid share
        where the truth is >= 256 px no more than LR_SHARE_GAP below the
        share elsewhere (the LR check's key past 8 bits);
        examples.stereo_live on 60 synthetic frames at 0.7 (counts
        60 x K1 1, K2 1 / 2, K3 1; frames 0-2 equal to the single-pair
        path); examples.mono (small, the committed demo PNG); the
        tools.profile_kernels stage table; tools.halo_sweep at 1080p, 8
        tiles (seam mismatch < 0.5 % at halo >= 64 without speckle);
        entry()'s function; dryrun(1) over NCCL, and dryrun(n) with one
        process per GPU when n > 1 are visible;
     i. the compiled-program caches as CUDA graphs (graphs.py), against
        the eager functions on the card: for the default, north star,
        rectified hh4, hh and census cells at 1080x1920x128 and
        examples.stereo's two Middlebury shapes (994x1482 and 1988x2964,
        D = 144, the second through the rectified graph), the first
        estimate_depth_async (warm-up, capture, instantiation and the
        graph's pool bytes) and a replay equal bit for bit to
        prepare_rectified + stereo_depth_fn on the same raw pair, with the
        (calls, launches) of the eager pair and of phase 3's path; eager
        against graphed host enqueue ms, kernel ms and idle share
        (host_device_split) and ms per pair with the read-back; a temporal
        sequence of 3 frames with a reset_temporal() before the third and
        the injected-matcher seam, each equal to the eager functions; the
        mono `small` forward at 518x518 through predict_async against the
        eager net (MONO_GRAPH_TOL), timed both ways. (Phase 3d's streams
        run on the graphs, each frame also held to the eager functions,
        and its frame splits give the eager frame beside the graphed one.)
     j. above 256 disparities and the float32 route (phase_wide): hh4 and
        hh at D = 288 through StereoDepthEstimator on a 240x720 pair moved
        270 px, counts exactly the wide variants of the path (K3's up and
        diagonal passes), the shift on >= 95 %, kernels == plain versions;
        bench.py's hh_8path_1080p_256d (hh, no speckle, fast mode) on the
        1080x1920 pair at D = 256 and 272, each side of the switch to the
        wide K2 and K3: exact counts, the shift on >= 95 %, K2 and both K3
        passes == plain versions and timed, ms per pair;
        BT at block size 15 (past the int16 bounds) at 256x640x64 through
        the facade's graph: a replay equal to the eager functions, one
        float32_route call and no matcher launch a pair (the WTA kernel's
        one launch and the speckle filter's two calls only), card == CPU,
        and
        ValueError above 1 << 26 cells on the card;
  4. one JSON line {"kernels": [...]}: per kernel the wrapper calls and
     kernel launches counted in phase 3 in one pair of the path named, ms
     per call, its bound, the loss per pair, calls x (ms - bound_ms), its
     launches in phase 3g's batch_pipeline, and under "middlebury" its
     launches, ms, plain ms, bound and error in phase 3h at each shape;
     then the wide variants of K2 and K3 with their numbers at 1988x2964x288
     (phase 3h) and the launches of their path (3h, or 3j's hh4 and hh);
  5. one JSON line {"streams": {...}} with phase 3d's numbers, one JSON
     line {"wide": {...}} with phase 3j's, one JSON
     line {"mono": {...}} with phase 3e's beside the card's name and power
     limit, one JSON line {"train": {...}, "parallel": {...}} with phases
     3f and 3g's, the card's name and power limit, one JSON line
     {"surface": {...}} with phase 3h's, one JSON line {"graphs": {...}}
     with phase 3i's, the card's name and power limit on a line of its
     own, then the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or depthestimation_tpu.
"""

from __future__ import annotations

import json
import os
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


def hold_exact(name, got, want, errs, phase="2"):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"plain {want.dtype}{tuple(want.shape)}")
    errs[name] = max_abs_err(got, want)
    log(f"[{phase}] {name}: {got.dtype} {tuple(got.shape)} max_abs_err {errs[name]}")
    if errs[name] != 0:
        raise AssertionError(f"{name} disagrees with its plain version")


def counted():
    """{kernel: (wrapper calls, launches)} since the last reset, for every
    kernel called or launched."""
    from depthestimation_torch.ops import cuda_sgm

    return {k: (cuda_sgm.CALLS[k], n)
            for k, n in cuda_sgm.LAUNCHES.items() if n or cuda_sgm.CALLS[k]}


def tail_counts(cfg, fast_mode, pairs=1):
    """The {name: (calls, launches)} in `pairs` pairs of a path of the
    kernels after K3: the WTA stage's one call of one launch a pair, and
    the speckle filter's calls of four launches, one in the matcher where
    cfg.speckle_window_size > 0 and one in the postprocess unless
    fast_mode."""
    calls = pairs * (int(cfg.speckle_window_size > 0) + int(not fast_mode))
    return {"wta": (pairs, pairs), **({"speckle": (calls, 4 * calls)} if calls else {})}


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
    types of each mode); named as their wrapper counts them (the wide
    variants' names above 256 disparities)."""
    from depthestimation_torch.ops import cuda_sgm

    acc4, acc8 = cuda_sgm._acc_dtype(cfg4), cuda_sgm._acc_dtype(cfg8)
    passes = [
        (swe, cfg, (0,), False, cuda_sgm._final_dtype(cfg)),
        (cuda_sgm.rowsweep(c, swe, cfg4, (0,), False, acc4),
         cfg4, (0,), True, cuda_sgm._final_dtype(cfg4)),
        (swe, cfg8, (0, 1, -1), False, acc8),
        (cuda_sgm.rowsweep(c, swe, cfg8, (0, 1, -1), False, acc8),
         cfg8, (0, -1, 1), True, cuda_sgm._final_dtype(cfg8)),
    ]
    return {cuda_sgm._rowsweep_name(p[2], p[3], c.shape[-1]): p for p in passes}


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


# Kernel classes by name, first match wins: cuDNN convolutions (forward,
# data and weight gradients; their implicit GEMMs carry "gemm" and "xmma"
# too, so they are matched first), cuBLAS/CUTLASS matrix products, NCCL,
# the optimizer's fused passes, the softmax.
KERNEL_CLASSES = (("conv", ("conv", "cudnn", "wgrad", "dgrad", "fprop", "implicit")),
                  ("gemm", ("gemm", "cutlass", "xmma", "cublas")),
                  ("all_gather", ("allgather",)), ("nccl", ("nccl",)),
                  ("optimizer", ("multi_tensor", "adam")),
                  ("softmax", ("softmax",)))


def kernel_classes(kernels) -> dict:
    """Kernel ms of a profiler trace's kernels summed by KERNEL_CLASSES,
    the rest under "other" (elementwise, reductions, copies), and the
    five kernel names with the most ms (name cut to 90 characters, ms,
    count) under "top"."""
    out, by_name = {}, {}
    for e in kernels:
        name = e.name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        ms = e.time_range.elapsed_us() / 1e3
        out[cls] = out.get(cls, 0.0) + ms
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + ms, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    out["top"] = [(name[:90], ms, count) for name, (ms, count) in top]
    return out


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
      as a Chrome trace under trace_dir when one is given;
      kernel_ms_by_class, that kernel time by kernel_classes.
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
    # The device timeline also carries user-annotation ranges (the
    # optimizer's record_function spans); those are not kernels.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0
    split = {"host_ms": float(np.median(idle)),
             "host_behind_sleep_ms": float(np.median(busy)),
             "device_events_ms": float(np.median(dev)),
             "kernel_ms": kernel_us / 1e3, "span_ms": span_us / 1e3,
             "kernels": len(kernels), "sleep_ms": sleep_ms,
             "kernel_ms_by_class": kernel_classes(kernels)}
    # The profiler slows the host's launches, so the idle share inside
    # the traced call reads higher than card_idle_share.
    split["card_idle_share"] = (max(0.0, 1.0 - split["kernel_ms"] / split["host_ms"])
                                if kernels else None)
    split["traced_idle_share"] = (1.0 - kernel_us / span_us) if span_us else None
    return split


def eager_pair(core, left, right, prev=None):
    """The eager functions the pipeline's graphs capture, on a raw pair:
    prepare_rectified, then stereo_depth_fn."""
    from depthestimation_torch.pipeline import stereo_depth_fn

    gl, gr = core.prepare_rectified(left, right)
    return stereo_depth_fn(gl, gr, core.cfg, core.downscale_factor, core.fast_mode,
                           prev_disp=prev)


def frame_split(vid, left, right, cycles_per_ms, tag, trace_dir):
    """host_device_split of one steady-state frame of the facade (compute,
    depth cast and read-back copies, as StereoDepthEstimatorVideo enqueues
    them) on a pair already staged on the card: the frame as the facade
    runs it (a replay of the pipeline's CUDA graph and one of the stats
    graph), and under "eager" the same frame from the eager functions. The
    graphed frame's trace goes to trace_dir/trace_<tag> when a trace_dir
    is given."""
    core = vid.core

    def frame():
        return vid._readback(*core.estimate_depth_async(left, right))

    def eager_frame():
        prev = core._prev_disp if core.cfg.temporal_alpha > 0 else None
        disp, depth = eager_pair(core, left, right, prev)
        if depth is not None and vid.depth_dtype == "float16":
            depth = depth.to(torch.float16)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in (vid._disp_stats(disp), depth) if t is not None]
        done = torch.cuda.Event()
        done.record()
        return host, done

    split = host_device_split(frame, cycles_per_ms,
                              trace_dir and f"{trace_dir}/trace_{tag}")
    split["eager"] = host_device_split(eager_frame, cycles_per_ms)
    log(f"[3d] {tag} one steady frame: {split}")
    return split


def phase_streaming(raw_pair, cycles_per_ms, trace_dir):
    """Streams A, B and C through StereoDepthEstimatorVideo; returns the
    numbers to print."""
    from depthestimation_torch import (SGMConfig, StereoDepthEstimator,
                                       StereoDepthEstimatorVideo)
    from depthestimation_torch.io.threaded import PairStager
    from depthestimation_torch.metrics import frame_metrics_from_stats
    from depthestimation_torch.pipeline import StereoPipeline

    result = {}

    # -- A: 40 uint8 1080p frames, fast mode, north-star flags, hh4 --
    n_a = 40
    frames_a = drifted(texture_pair(H, W, SHIFT, seed=0), n_a)
    expect_a = {"cost_volume": (n_a, n_a), "hscan": (n_a, 2 * n_a),
                "rowsweep": (n_a, n_a), "rowsweep_up": (n_a, n_a),
                **tail_counts(SGMConfig().updated(**STREAM_A), True, n_a)}
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
        eager = eager_pair(single.core, frames_a[0][i], frames_a[1][i])[1]
        if not np.array_equal(out_a[i].view(np.uint16),
                              eager.half().cpu().numpy().view(np.uint16)):
            raise AssertionError(f"A: frame {i} differs from the eager functions")
        disp = 1000.0 * 0.12 / out_a[i].astype(np.float32)
        hit = float((np.abs(disp - SHIFT) <= 1.0).mean())
        log(f"[3d] A frame {i}: == single-pair and eager float16 depth (bit for bit); "
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
                "rowsweep_up": (n_b, n_b),
                **tail_counts(SGMConfig().updated(**rig), False, n_b)}
    out_b, sum_b = run_stream(frames_b, rig, expect_b, "B threaded",
                              use_threading=True)
    ref = StereoPipeline(device="cuda")
    ref.configure(**rig)
    prev = None
    for i, (l, r) in enumerate(zip(*frames_b)):
        want = ref.estimate_depth(l, r)[1]
        if out_b[i].dtype != np.float32 or not np.array_equal(
                out_b[i].view(np.uint32), want.view(np.uint32)):
            raise AssertionError(f"B: frame {i} differs from StereoPipeline's")
        prev, eager = eager_pair(ref, l, r, prev)
        if not np.array_equal(out_b[i].view(np.uint32), eager.cpu().numpy().view(np.uint32)):
            raise AssertionError(f"B: frame {i} differs from the eager functions")
    log(f"[3d] B: all {n_b} frames == StereoPipeline.estimate_depth and the eager "
        "functions with the temporal carry (float32, bit for bit)")
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
# The graphed forward against the eager one on the card, the same share:
# the same kernels, so bit-equal is expected, but cuDNN's transposed
# convolution may sum with atomics.
MONO_GRAPH_TOL = 1e-5


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


# ---- 3f. the mono training step ----
TRAIN_BATCH, TRAIN_HW, TRAIN_LR, TRAIN_STEPS = 4, 518, 1e-4, 5
# The card's step is held against the CPU's, TF32 off, with the head's
# output bias raised to 2 so that every prediction is clear of the final
# ReLU's kink (checked on the CPU: min > 0.1). At the seeded init part of
# the outputs sit at that kink, where SiLog's gradient is discontinuous (an
# output of 1e-8 on one device and 0 on the other weighs 1 / (pred + 1e-6)
# on one side only), so there the gradients are reported, not held.
# Tolerances: the loss to 1e-5 relative; gradients per parameter to 1e-3
# of its max |g| (float32 sums over 4 x 518 x 518 pixels in other orders);
# weights after the step to 1e-2 * lr where the CPU's gradient is above the
# gradient tolerance, else to 2 * lr (Adam's first step moves a weight by
# about lr * sign(g), and a noise-level g's sign is either).
TRAIN_OUT_BIAS = 2.0
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-3, "weight": 1e-2 * TRAIN_LR,
             "noise_weight": 2 * TRAIN_LR * (1 + 1e-3)}


def _train_step_card_vs_cpu(net, mesh, images, targets):
    """One make_train_step on the card against the plain step on the CPU
    (SiLog over the whole batch, backward, AdamW with optax.adamw's
    defaults, every parameter decayed), TF32 off. Returns the errors and
    the CPU's predictions' minimum and share at 0."""
    import copy

    from depthestimation_torch.models import train

    hw = images.shape[1:3]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    local, opt, shardings = train.make_sharded_train_state(net, mesh, hw, TRAIN_LR, seed=None)
    loss = float(train.make_train_step(local, opt, mesh, shardings)(images, targets))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    ref = copy.deepcopy(net)
    ref_opt = torch.optim.AdamW(ref.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    t0 = time.perf_counter()
    t = torch.from_numpy(targets)
    pred = ref(torch.from_numpy(images))
    ref_loss = train.silog_loss(pred, t, t > 0)
    ref_loss.backward()
    ref_opt.step()
    cpu_s = time.perf_counter() - t0
    out = {"loss": loss, "cpu_loss": float(ref_loss.detach()),
           "pred_min": float(pred.detach().min()),
           "pred_zero_share": float((pred.detach() == 0).float().mean()),
           "grad_rel_err": 0.0, "weight_err_firm": 0.0, "weight_err_all": 0.0,
           "cpu_step_s": cpu_s}
    out["loss_rel_err"] = abs(loss - out["cpu_loss"]) / abs(out["cpu_loss"])
    named = {n: (p.grad, p.detach()) for n, p in local.named_parameters()}
    out.update(_step_errors(named, dict(ref.named_parameters())))
    return out


def _step_errors(named, ref_params):
    """The worst errors of a step's {name: (gradient, weight after it)}
    against the reference net's parameters after its step: gradients
    relative to each parameter's max |g|, weights where the reference
    gradient is above TRAIN_TOL["grad"] of its max (firm) and anywhere."""
    out = {"grad_rel_err": 0.0, "weight_err_firm": 0.0, "weight_err_all": 0.0}
    for name, (grad, weight) in named.items():
        g = ref_params[name].grad
        out["grad_rel_err"] = max(out["grad_rel_err"],
                                  float((grad.to(g.device) - g).abs().max() / g.abs().max()))
        diff = (weight.to(g.device) - ref_params[name].detach()).abs()
        firm = g.abs() > TRAIN_TOL["grad"] * g.abs().max()
        if firm.any():
            out["weight_err_firm"] = max(out["weight_err_firm"], float(diff[firm].max()))
        out["weight_err_all"] = max(out["weight_err_all"], float(diff.max()))
    return out


def _step_held(held) -> bool:
    return (held["loss_rel_err"] <= TRAIN_TOL["loss"]
            and held["grad_rel_err"] <= TRAIN_TOL["grad"]
            and held["weight_err_firm"] <= TRAIN_TOL["weight"]
            and held["weight_err_all"] <= TRAIN_TOL["noise_weight"])


def _train_data():
    """phase 3f's seeded batch: TRAIN_BATCH images in [0, 1] and targets
    in [0.5, 2], TRAIN_HW square, float32 numpy."""
    rng = np.random.default_rng(0)
    hw = (TRAIN_HW, TRAIN_HW)
    images = rng.uniform(0, 1, (TRAIN_BATCH, *hw, 3)).astype(np.float32)
    targets = rng.uniform(0.5, 2.0, (TRAIN_BATCH, *hw)).astype(np.float32)
    return images, targets


def _step_times(fn, cycles_per_ms):
    """One train step's times, fn() enqueuing it (the card keeps
    training): events, host clock, images/s, the profiler's kernels and
    the host's enqueue ms and the card's idle share (host_device_split)."""
    split = host_device_split(fn, cycles_per_ms)
    wall = host_ms(lambda: float(fn()), runs=5)
    return {"events_ms": split["device_events_ms"], "host_clock_ms": wall,
            "images_per_s_events": TRAIN_BATCH * 1e3 / split["device_events_ms"],
            "images_per_s_host_clock": TRAIN_BATCH * 1e3 / wall,
            "kernels": split["kernels"], "kernel_ms": split["kernel_ms"],
            "kernel_ms_by_class": split["kernel_ms_by_class"],
            "host_enqueue_ms": split["host_ms"],
            "card_idle_share": split["card_idle_share"],
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32}


def _train_run(net, mesh, images, targets, cycles_per_ms):
    """TRAIN_STEPS make_train_step steps from `net` on `mesh` at
    PyTorch's TF32 defaults (finite, falling losses; the first call runs
    the step and captures its CUDA graph, the others replay it), the peak
    memory allocated from the train state's creation on, the graph's
    first-use numbers, and one step's times graphed ("step") and eager
    ("step_eager", step.eager on the same state). Every rank of the mesh
    calls it alike. Returns the numbers."""
    from depthestimation_torch.models import train

    dev = torch.device("cuda", torch.cuda.current_device())
    xc = torch.from_numpy(images).to(dev)
    tc = torch.from_numpy(targets).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    local, opt, shardings = train.make_sharded_train_state(net, mesh, images.shape[1:3],
                                                            TRAIN_LR, seed=None)
    step = train.make_train_step(local, opt, mesh, shardings)
    losses = [float(step(xc, tc)) for _ in range(TRAIN_STEPS)]
    (entry,) = step.graph_cache.values()
    out = {"losses": losses, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "graph": dict(_graph_numbers(entry), replays=entry.replays)}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} not finite and falling")
    if entry.replays != TRAIN_STEPS - 1:
        raise AssertionError(f"train: {entry.replays} replays in {TRAIN_STEPS} steps")

    out["step"] = _step_times(lambda: step(xc, tc), cycles_per_ms)
    out["step_eager"] = _step_times(lambda: step.eager(xc, tc), cycles_per_ms)
    del local, opt, step, entry, xc, tc
    torch.cuda.empty_cache()
    return out


def _copy_train_state(dst, src):
    """Copy one train state's (net, optimizer) weights and AdamW state
    into another's tensors, in place."""
    (dst_net, dst_opt), (src_net, src_opt) = dst, src
    with torch.no_grad():
        for pd, ps in zip(dst_net.parameters(), src_net.parameters()):
            pd.copy_(ps)
            for k, v in src_opt.state[ps].items():
                dst_opt.state[pd][k].copy_(v)


def _graphed_vs_eager(net, mesh, images, targets):
    """TRAIN_STEPS steps through make_train_step's CUDA graph (the first
    runs the step and captures it, the others replay), each against an
    eager step (step.eager) of a second train state into which the
    graphed state (weights, AdamW moments and step count) was copied just
    before, TF32 off: every step's loss, gradients and weights held at
    TRAIN_TOL (_step_errors, the worst over the steps). Two runs that
    only start from the same weights drift apart over the steps (atomics
    reorder float sums, and Adam moves a weight by about lr whatever its
    gradient's size), so each step is held from one state. The
    capturable AdamW's step count, on the card, must read TRAIN_STEPS
    after the replays: a count frozen at the capture would give every
    replay the first step's bias correction, which the held weights
    would show. Returns the numbers; every rank of the mesh calls it
    alike."""
    from depthestimation_torch.models import train

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    graphed, eager = (train.make_sharded_train_state(net, mesh, images.shape[1:3], TRAIN_LR,
                                                     seed=None) for _ in range(2))
    step = train.make_train_step(graphed[0], graphed[1], mesh, graphed[2])
    eager_step = train.make_train_step(eager[0], eager[1], mesh, eager[2]).eager
    out = {"steps": TRAIN_STEPS, "losses_graphed": [], "losses_eager": [],
           "loss_rel_err": 0.0, "grad_rel_err": 0.0, "weight_err_firm": 0.0,
           "weight_err_all": 0.0}
    for k in range(TRAIN_STEPS):
        if k:
            _copy_train_state(eager[:2], graphed[:2])
        out["losses_graphed"].append(float(step(images, targets)))
        out["losses_eager"].append(float(eager_step(images, targets)))
        errs = _step_errors({n: (p.grad, p.detach()) for n, p in graphed[0].named_parameters()},
                            dict(eager[0].named_parameters()))
        errs["loss_rel_err"] = (abs(out["losses_graphed"][-1] - out["losses_eager"][-1])
                                / abs(out["losses_eager"][-1]))
        out.update({key: max(out[key], v) for key, v in errs.items()})
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (entry,) = step.graph_cache.values()
    opt = graphed[1]
    counts = sorted({float(st["step"]) for st in opt.state.values()})
    out.update(replays=entry.replays, adam_step_counts=counts,
               adam_steps_on_card=all(st["step"].is_cuda for st in opt.state.values()),
               capturable=opt.defaults["capturable"], tolerance=TRAIN_TOL,
               head_out_bias=TRAIN_OUT_BIAS)
    out["held"] = bool(_step_held(out) and out["capturable"] and out["adam_steps_on_card"]
                       and out["replays"] == TRAIN_STEPS - 1
                       and counts == [float(TRAIN_STEPS)])
    del graphed, eager, step, eager_step, entry, opt
    torch.cuda.empty_cache()
    return out


def phase_train(cycles_per_ms, smi):
    """make_train_step on `small` at 4x518x518 over an NCCL group of one
    rank (mesh (1, 1, 1)): one step against the plain step on the CPU
    (TF32 off), TRAIN_STEPS steps with a falling loss, and the step's
    times, memory and kernel count. Returns (mesh, the numbers to print)."""
    import copy

    import torch.distributed as dist

    from depthestimation_torch.models.mono import MonoDepthModel
    from depthestimation_torch.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1, 1))
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError(f"train: group {dist.get_backend()}, mesh {mesh.device_type}")
    hw = (TRAIN_HW, TRAIN_HW)
    images, targets = _train_data()
    net = MonoDepthModel.create("small", seed=0, image_size=TRAIN_HW, device="cpu").net
    result = {"card": smi, "batch": [TRAIN_BATCH, *hw, 3], "lr": TRAIN_LR, "mesh": [1, 1, 1],
              "backend": dist.get_backend(), "tolerance": TRAIN_TOL}

    # -- one step, card against CPU, TF32 off: held clear of the ReLU's
    # kink, reported at the seeded init --
    lifted = copy.deepcopy(net)
    with torch.no_grad():
        lifted.head.head_out.bias.fill_(TRAIN_OUT_BIAS)
    held = _train_step_card_vs_cpu(lifted, mesh, images, targets)
    result["card_vs_cpu"] = dict(held, head_out_bias=TRAIN_OUT_BIAS)
    log(f"[3f] one step, TF32 off, output bias {TRAIN_OUT_BIAS}, card vs CPU: {held}")
    if not (held["pred_min"] > 0.1 and _step_held(held)):
        raise AssertionError("train: the card's step differs from the CPU's")
    result["card_vs_cpu_seeded_init"] = _train_step_card_vs_cpu(net, mesh, images, targets)
    log(f"[3f] one step at the seeded init (reported, not held): "
        f"{result['card_vs_cpu_seeded_init']}")

    # -- TRAIN_STEPS graphed steps against as many eager ones, TF32 off --
    result["graphed_vs_eager"] = _graphed_vs_eager(lifted, mesh, images, targets)
    log(f"[3f] {TRAIN_STEPS} graphed steps vs eager, TF32 off: {result['graphed_vs_eager']}")
    if not result["graphed_vs_eager"]["held"]:
        raise AssertionError("train: the graphed steps differ from the eager ones")
    del lifted

    # -- TRAIN_STEPS steps from the seeded weights, PyTorch's defaults --
    result.update(_train_run(net, mesh, images, targets, cycles_per_ms))
    log(f"[3f] {TRAIN_STEPS} steps: losses {result['losses']}; peak memory "
        f"{result['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    log(f"[3f] the step's graph: {result['graph']}")
    log(f"[3f] one step, graphed: {result['step']}")
    log(f"[3f] one step, eager: {result['step_eager']}")
    return mesh, result


# ---- 3g. the parallel layer ----
TILE_SEAM_ROWS = 8  # rows each side of a seam counted as the seam (tests/test_sharding.py)


def _frames(n, dev):
    """n integer texture pairs (phase 3's, brightness drifted +i) as
    (n, H, W) float32 grayscale on dev."""
    return tuple(torch.tensor(np.stack([img[..., 0] for img in side]), dtype=torch.float32,
                              device=dev)
                 for side in drifted(texture_pair(H, W, SHIFT, seed=0), n))


def _check_batch_and_disp(mesh_batch, mesh_lanes, lb, rb, tag):
    """batch_pipeline on this rank's frames: its first call (the eager
    warm-up, then the capture of its CUDA graph) and a replay, each
    launching K1 1, K2 1/2, K3 1 a frame, every frame of both equal bit
    for bit to raw_disparity + postprocess_and_depth, the replay equal to
    run.eager; disp_sharded_sgm on frame 0 equal to the kernels' matcher.
    Returns (counts, disp_sharded_sgm ms, the batch_pipeline function)."""
    from depthestimation_torch import SGMConfig
    from depthestimation_torch.ops import cuda_sgm
    from depthestimation_torch.parallel import shard
    from depthestimation_torch.pipeline import postprocess_and_depth, raw_disparity

    cfg = SGMConfig(num_disp=D, focal_length=1000.0, baseline=0.1)
    run = shard.batch_pipeline(mesh_batch, cfg, fast_mode=True)
    n = lb.shape[0]
    expected = {"cost_volume": (n, n), "hscan": (n, 2 * n), "rowsweep": (n, n),
                **tail_counts(cfg, True, n)}
    outs = []
    for call in ("first call", "replay"):
        cuda_sgm.reset_launches()
        outs.append(run(lb, rb))
        torch.cuda.synchronize()
        counts = counted()
        log(f"[3g] {tag} batch_pipeline, {n} frames, {call}: (calls, launches) {counts}")
        if counts != expected:
            raise AssertionError(f"{tag} batch_pipeline's {call} made {counts}, "
                                 f"expected {expected}")
    (entry,) = run.graph_cache.values()
    eager = run.eager(lb, rb)
    if entry.replays != 1 or not all(torch.equal(a, b) for a, b in zip(outs[1], eager)):
        raise AssertionError(f"{tag} batch_pipeline: the replay ({entry.replays}) differs "
                             "from run.eager")
    for i in range(n):
        want = postprocess_and_depth(raw_disparity(lb[i], rb[i], cfg), cfg, fast_mode=True)
        for call, (disp, depth) in zip(("first call", "replay"), outs):
            if not (torch.equal(disp[i], want[0]) and torch.equal(depth[i], want[1])):
                raise AssertionError(f"{tag} batch_pipeline's {call}, frame {i}, differs "
                                     "from the single pair")
    del outs, eager
    ns = SGMConfig(num_disp=D, speckle_window_size=0)
    fn = shard.disp_sharded_sgm(mesh_lanes, ns)
    t0 = time.perf_counter()
    got = fn(lb[0], rb[0])
    torch.cuda.synchronize()
    sgm_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, raw_disparity(lb[0], rb[0], ns)):
        raise AssertionError(f"{tag} disp_sharded_sgm differs from the kernels' matcher")
    log(f"[3g] {tag}: every frame of the first call and of a replay == raw_disparity + "
        f"postprocess_and_depth (bit for bit), the replay == run.eager; "
        f"disp_sharded_sgm == the kernels' matcher (bit for bit), {sgm_ms:.1f} ms")
    return counts, sgm_ms, run


def _check_tiles(mesh_tiles, lb, rb, tag):
    """batch_pipeline with each frame's rows over the mesh's 'tile' axis
    (halo exchange by NCCL send and receive, the tiles all-gathered): its
    first call (eager, then the capture) and a replay equal bit for bit
    to run.eager on every rank."""
    from depthestimation_torch import SGMConfig
    from depthestimation_torch.parallel import shard

    cfg = SGMConfig(num_disp=D, focal_length=1000.0, baseline=0.1)
    run = shard.batch_pipeline(mesh_tiles, cfg, fast_mode=True)
    outs = [run(lb, rb) for _ in range(2)]
    eager = run.eager(lb, rb)
    (entry,) = run.graph_cache.values()
    for call, out in zip(("first call", "replay"), outs):
        if not all(torch.equal(a, b) for a, b in zip(out, eager)):
            raise AssertionError(f"{tag} tiled batch_pipeline's {call} differs from run.eager")
    if entry.replays != 1:
        raise AssertionError(f"{tag} tiled batch_pipeline: {entry.replays} replays")
    log(f"[3g] {tag}: tiled batch_pipeline, first call and replay == run.eager (bit for bit)")


def _multi_gpu_rank(rank, world, port):
    """One rank of the one-process-per-GPU check (torch.multiprocessing):
    _check_batch_and_disp on the rank's own frame, then the same frames'
    rows over every GPU (_check_tiles)."""
    from depthestimation_torch.parallel.mesh import (destroy_process_group,
                                                     initialize_distributed, make_mesh)

    initialize_distributed(f"localhost:{port}", world, rank)
    dev = torch.device("cuda", rank)
    lb, rb = _frames(world, dev)
    tag = f"rank {rank}/{world}"
    _check_batch_and_disp(make_mesh((world, 1, 1)), make_mesh((1, 1, world)),
                          lb[rank:rank + 1], rb[rank:rank + 1], tag)
    _check_tiles(make_mesh((1, world, 1)), lb[:2], rb[:2], tag)
    destroy_process_group()


def _spawn_multi_gpu(world):
    """_multi_gpu_rank in one process per GPU."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_multi_gpu_rank, args=(world, port), nprocs=world, join=True)
    log(f"[3g] {world} processes, one per GPU: batch_pipeline (graphed and eager), "
        "disp_sharded_sgm and the tiled batch_pipeline checks passed on every rank")


# predict_sharded at (1, 1, 4) against the single forward, both float32
# with TF32 off, relative to the forward's max: the partial products of
# proj and fc2 summed over the ranks change the order of additions only.
TP_PREDICT_TOL = 1e-5


def _tensor_parallel_rank(rank, world, port, cycles_per_ms, out_path):
    """One rank of the tensor-parallel check over every GPU, mesh
    (world // 4, 1, 4). `small`'s 6 heads do not split over 4 'model'
    ranks, so qkv and proj take JAX's contiguous layout (models/train.py):
    - one make_train_step with TF32 off from phase 3f's batch and weights
      (the head's output bias at TRAIN_OUT_BIAS), its gathered gradients
      and weights held on rank 0 under TRAIN_TOL to the plain step of the
      whole net on that card (what make_train_step runs at mesh (1, 1, 1),
      which phase 3f holds to the CPU), and the replicated parameters
      equal bit for bit across the 'model' ranks after it;
    - predict_sharded at 2x518x518, TF32 off, within TP_PREDICT_TOL of the
      max of the single forward on the rank's card;
    - _train_run at PyTorch's defaults: ms a step, peak memory, and the
      all-gather's share of the step from the profiler.
    Rank 0 writes the numbers to out_path as JSON."""
    import copy

    import torch.distributed as dist

    from depthestimation_torch.models import train
    from depthestimation_torch.models.mono import MonoDepthModel
    from depthestimation_torch.parallel.mesh import (destroy_process_group,
                                                     initialize_distributed, make_mesh)

    initialize_distributed(f"localhost:{port}", world, rank)
    dev = torch.device("cuda", rank)
    shape = (world // 4, 1, 4)
    mesh = make_mesh(shape)
    images, targets = _train_data()
    net = MonoDepthModel.create("small", seed=0, image_size=TRAIN_HW, device="cpu").net
    lifted = copy.deepcopy(net)
    with torch.no_grad():
        lifted.head.head_out.bias.fill_(TRAIN_OUT_BIAS)
    out = {"mesh": list(shape), "backend": dist.get_backend(), "processes": world,
           "batch": [TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3], "heads": net.vit_cfg.num_heads}

    # -- one step with TF32 off, and the replicas after it --
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    local, opt, shardings = train.make_sharded_train_state(lifted, mesh, images.shape[1:3],
                                                            TRAIN_LR, seed=None)
    attn = local.backbone.block_0.attn
    out["heads_per_rank"] = attn.num_heads
    out["qkv_rows_per_rank"] = attn.qkv.weight.shape[0]
    loss = float(train.make_train_step(local, opt, mesh, shardings)(images, targets))
    grads = train.gather_params({n: p.grad for n, p in local.named_parameters()}, mesh,
                                shardings)
    weights = train.gather_params({n: p.detach() for n, p in local.named_parameters()},
                                  mesh, shardings)
    model_group = mesh.get_group("model")
    replicated = torch.cat([p.detach().reshape(-1) for n, p in local.named_parameters()
                            if shardings[n] is None])
    first = replicated.clone()
    dist.broadcast(first, src=dist.get_global_rank(model_group, 0), group=model_group)
    out["replicas_equal"] = bool(torch.equal(first, replicated))
    del local, opt, replicated, first
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # -- TRAIN_STEPS graphed steps against as many eager ones at this mesh --
    out["graphed_vs_eager"] = _graphed_vs_eager(lifted, mesh, images, targets)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    # -- predict_sharded against the single forward; a replay against eager --
    model = MonoDepthModel.create("small", seed=0, device=dev)
    x = torch.rand(2, 518, 518, 3, generator=torch.Generator().manual_seed(1))
    got = model.predict_sharded(x, mesh)
    with torch.no_grad():
        want = model.net(x.to(dev)).cpu().numpy()
    out["predict_sharded"] = {"batch": [2, 518, 518, 3],
                              "rel_err": float(np.abs(got - want).max() / np.abs(want).max())}
    out["predict_sharded"].update(_predict_replay(model, mesh, x))
    del model

    if rank == 0:
        ref = copy.deepcopy(lifted).to(dev)
        ref_opt = torch.optim.AdamW(ref.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=1e-4)
        t = torch.from_numpy(targets).to(dev)
        ref_loss = train.silog_loss(ref(torch.from_numpy(images).to(dev)), t, t > 0)
        ref_loss.backward()
        ref_opt.step()
        held = {"loss": loss, "one_rank_loss": float(ref_loss.detach())}
        held["loss_rel_err"] = abs(loss - held["one_rank_loss"]) / abs(held["one_rank_loss"])
        held.update(_step_errors({n: (grads[n], weights[n]) for n in grads},
                                 dict(ref.named_parameters())))
        out["vs_one_rank"] = dict(held, head_out_bias=TRAIN_OUT_BIAS, tolerance=TRAIN_TOL)
        del ref, ref_opt
    del grads, weights, lifted
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # -- TRAIN_STEPS steps from the seeded weights, PyTorch's defaults --
    out.update(_train_run(net, mesh, images, targets, cycles_per_ms))
    step = out["step"]
    gather_ms = step["kernel_ms_by_class"].get("all_gather", 0.0)
    out["all_gather"] = {"kernel_ms": gather_ms,
                         "share_of_kernel_ms": gather_ms / step["kernel_ms"],
                         "share_of_step_events_ms": gather_ms / step["events_ms"]}
    ranks = [None] * world
    dist.all_gather_object(ranks, (out["max_memory_allocated_bytes"], out["replicas_equal"],
                                   out["predict_sharded"]["rel_err"],
                                   out["graphed_vs_eager"]["held"],
                                   out["predict_sharded"]["replay_rel_err"]))
    destroy_process_group()
    out["max_memory_allocated_bytes_per_rank"] = [r[0] for r in ranks]
    out["replicas_equal_per_rank"] = [r[1] for r in ranks]
    out["predict_sharded"]["rel_err_per_rank"] = [r[2] for r in ranks]
    out["graphed_vs_eager_held_per_rank"] = [r[3] for r in ranks]
    out["predict_sharded"]["replay_rel_err_per_rank"] = [r[4] for r in ranks]
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def phase_tensor_parallel(world, cycles_per_ms, one_rank):
    """_tensor_parallel_rank in one process per GPU (world of them, 4 or
    more), against `one_rank` (_train_run's numbers at mesh (1, 1, 1)).
    Returns the numbers to print; raises unless every hold passed."""
    import socket

    import torch.multiprocessing as mp

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "tensor_parallel.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_tensor_parallel_rank, args=(world, port, cycles_per_ms, path), nprocs=world,
             join=True)
    with open(path) as f:
        out = json.load(f)
    out["one_rank"] = {"mesh": [1, 1, 1], "step": one_rank["step"],
                       "max_memory_allocated_bytes": one_rank["max_memory_allocated_bytes"]}
    out["step_host_clock_ms_ratio"] = (out["step"]["host_clock_ms"]
                                       / one_rank["step"]["host_clock_ms"])
    log(f"[3g] tensor parallel {out['mesh']}, {out['heads']} heads, "
        f"{out['heads_per_rank']} a rank: one step vs one rank {out['vs_one_rank']}; "
        f"replicas equal {out['replicas_equal_per_rank']}; predict_sharded "
        f"{out['predict_sharded']}; ms a step {out['step']['host_clock_ms']:.2f} "
        f"(one rank {one_rank['step']['host_clock_ms']:.2f}); peak bytes a rank "
        f"{out['max_memory_allocated_bytes_per_rank']} (one rank "
        f"{one_rank['max_memory_allocated_bytes']}); all-gather {out['all_gather']}")
    log(f"[3g] tensor parallel: {TRAIN_STEPS} graphed steps vs eager on rank 0 "
        f"{out['graphed_vs_eager']}, held on every rank {out['graphed_vs_eager_held_per_rank']}; "
        f"graphed step {out['step']}; eager step {out['step_eager']}")
    held = out["vs_one_rank"]
    if not (out["heads_per_rank"] == out["heads"] and _step_held(held)
            and all(out["replicas_equal_per_rank"])
            and max(out["predict_sharded"]["rel_err_per_rank"]) <= TP_PREDICT_TOL):
        raise AssertionError("tensor parallel: the (1, 1, 4) step or predict_sharded "
                             "differs from one rank")
    if not (all(out["graphed_vs_eager_held_per_rank"])
            and max(out["predict_sharded"]["replay_rel_err_per_rank"]) <= MONO_GRAPH_TOL):
        raise AssertionError("tensor parallel: a graphed step or predict differs from eager")
    return out


def _predict_replay(model, mesh, x):
    """After a first model.predict_sharded(x, mesh) (which captured the
    graph): a second call with other images, a replay, against the
    sharded predict's eager run on them, relative to its max."""
    predict = model._graph_cache[("sharded", mesh, tuple(x.shape[1:]), "data")]
    x2 = x.flip(0).contiguous()
    got = model.predict_sharded(x2, mesh)
    want = predict.eager(x2).cpu().numpy()
    (entry,) = predict.graph_cache.values()
    return {"replays": entry.replays,
            "replay_rel_err": float(np.abs(got - want).max() / np.abs(want).max()),
            **_graph_numbers(entry)}


def phase_parallel(mesh, cycles_per_ms, train_numbers):
    """batch_pipeline, disp_sharded_sgm, the tile function tile by tile
    and predict_sharded on the one-rank mesh; with several GPUs, the first
    two again with one process per GPU, and with four or more the
    tensor-parallel check (phase_tensor_parallel) against phase 3f's
    one-rank step. Returns the numbers to print."""
    from depthestimation_torch import SGMConfig
    from depthestimation_torch.models.mono import MonoDepthModel
    from depthestimation_torch.parallel import shard
    from depthestimation_torch.pipeline import raw_disparity

    dev = torch.device("cuda")
    lb, rb = _frames(4, dev)
    counts, sgm_ms, run = _check_batch_and_disp(mesh, mesh, lb, rb, "1 rank")
    (entry,) = run.graph_cache.values()
    result = {"batch_pipeline_frames": 4, "batch_pipeline_counts": counts,
              "disp_sharded_sgm_host_ms": sgm_ms,
              "batch_pipeline": {
                  **_graph_numbers(entry),
                  "eager": _split_numbers(host_device_split(lambda: run.eager(lb, rb),
                                                            cycles_per_ms)),
                  "graphed": _split_numbers(host_device_split(lambda: run(lb, rb),
                                                              cycles_per_ms)),
                  "eager_ms_per_batch": host_ms(lambda: run.eager(lb, rb)[0].cpu()),
                  "graphed_ms_per_batch": host_ms(lambda: run(lb, rb)[0].cpu())}}
    result["batch_pipeline"]["replays"] = entry.replays
    log(f"[3g] batch_pipeline, 4 frames, eager vs graphed: {result['batch_pipeline']}")
    del run, entry

    # -- 4 row tiles with DEFAULT_HALO, tile by tile, against the whole image --
    cfg = SGMConfig(num_disp=D, sgbm_mode="hh4", speckle_window_size=50)
    n_tiles, halo = 4, shard.DEFAULT_HALO
    tiled = torch.cat([shard.tile_disparity(shard.tile_with_halo(lb[0], n_tiles, i, halo),
                                            shard.tile_with_halo(rb[0], n_tiles, i, halo),
                                            cfg, halo) for i in range(n_tiles)])
    whole = raw_disparity(lb[0], rb[0], cfg)
    diff = ((tiled - whole).abs() > 1 / 16 + 1e-6).cpu().numpy()
    seams = [r for i in range(1, n_tiles) for r in range(
        i * (H // n_tiles) - TILE_SEAM_ROWS, i * (H // n_tiles) + TILE_SEAM_ROWS)]
    result["tiles"] = {"n": n_tiles, "halo": halo, "mode": "hh4",
                       "seam_mismatch": float(diff[seams].mean()),
                       "total_mismatch": float(diff.mean())}
    log(f"[3g] {n_tiles} tiles, halo {halo}, hh4: mismatch {result['tiles']}")
    if not (result["tiles"]["seam_mismatch"] < 0.005 and result["tiles"]["total_mismatch"] < 0.005):
        raise AssertionError("tiles: mismatch against the whole image >= 0.5 %")

    # -- predict_sharded at world size 1 --
    model = MonoDepthModel.create("small", seed=0, device=dev)
    x = torch.rand(2, 518, 518, 3, generator=torch.Generator().manual_seed(1))
    got = model.predict_sharded(x, mesh)
    with torch.no_grad():
        want = model.net(x.to(dev)).cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError("predict_sharded differs from the net's forward")
    log("[3g] predict_sharded, 2x518x518, one rank == net(images) (bit for bit)")
    result["predict_sharded"] = {"batch": [2, 518, 518, 3], "equal": True,
                                 **_predict_replay(model, mesh, x)}
    predict = model._graph_cache[("sharded", mesh, (518, 518, 3), "data")]
    xc = x.to(dev)
    for how, fn in (("eager", predict.eager), ("graphed", predict)):
        result["predict_sharded"][how] = _split_numbers(host_device_split(
            lambda: fn(xc), cycles_per_ms))
    log(f"[3g] predict_sharded: a replay vs the eager run {result['predict_sharded']}")
    if result["predict_sharded"]["replay_rel_err"] > MONO_GRAPH_TOL:
        raise AssertionError("predict_sharded: the replay differs from the eager run")
    del model, predict

    # -- one process per GPU --
    world = 1 << (max(torch.cuda.device_count(), 1).bit_length() - 1)
    result["processes"] = world if world > 1 else None
    if world > 1:
        _spawn_multi_gpu(world)
    result["tensor_parallel"] = (phase_tensor_parallel(world, cycles_per_ms, train_numbers)
                                 if world >= 4 else None)
    if world < 4:
        log(f"[3g] tensor parallel at mesh (1, 1, 4): processes: None ({world} GPU), "
            "not run")
    return result


# ---- 3h. the user-facing surface ----
# examples/example_stereo.py's rig (its CLI defaults): a Middlebury pair,
# 2964x1988, 280 disparities, matched at downscale 0.5 with D = 144 and at
# 1.0 with D = 288.
MIDDLEBURY = dict(focal_px=3997.684, baseline_mm=193.001, doffs=131.111, width=2964,
                  height=1988, ndisp=280)
# The synthetic scene's own range: its nearest plane at 0.8 * 330 = 264 px
# (132 at 0.5), so that at 1.0 part of the truth lies at 256 or more,
# where the LR check's key must hold d0 past 8 bits.
SCENE_NDISP = 330
SURFACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "surface")


def kernel_work(name, h, w, d, acc_bytes=2, out_bytes=2, dirs=1):
    """(bytes, operations) of one call of a kernel at (h, w, d): each input
    read once, each output written once; operations per (y, x, d): K1 BT
    the pixel cost once (10) plus a separable running box sum (4), census
    XOR + popcount (2) plus the box sum; K2 two scan steps (9 each) plus
    the sum; K3 one scan step plus the sum per direction. Remap: both
    images and their maps read, both outputs written, ~17 operations a
    pixel. Speckle (d unused): the (h, w) float32 map read once and
    written once, ~10 operations a pixel (two edge tests and the verdict).
    WTA: S read once (acc_bytes a value) and the float32 map written once,
    ~6 operations a value (the key and its minimum, the competitor's mask
    and minimum)."""
    n = h * w * d
    if name == "remap":
        return 2 * h * w * 4 * 4, 2 * h * w * 17
    if name.startswith("speckle"):
        return h * w * 4 * 2, h * w * 10
    if name.startswith("cost_volume"):
        return 2 * h * w * 4 + n * 2, n * (6 if name.endswith("census") else 14)
    if name.startswith("hscan"):
        return n * (2 + acc_bytes), n * 19
    if name == "wta":
        return n * acc_bytes + h * w * 4, n * 6
    return n * (2 + acc_bytes + out_bytes), n * 10 * dirs


def bound(nbytes, nops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the operations over its 32-bit rate."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# The LR check above 256 disparities holds when the raw valid share where
# the truth is >= 256 px is at most this far below the share elsewhere.
LR_SHARE_GAP = 0.05


def _lr_shares(est, truth):
    """The LR check above 256 disparities on the example's own pair: the
    share of valid raw disparities (the kernels' matcher, before the
    postprocess fills holes) where the truth is 256 px or more, against
    the share where it is below. With the JAX version's key (d0 & 255)
    the first would be about 0."""
    from depthestimation_torch.pipeline import raw_disparity

    cfg = est.core.cfg
    raw = raw_disparity(est.core.left_rectified, est.core.right_rectified, cfg)
    valid = (raw[:, cfg.num_disp:] != cfg.min_disp - 1).cpu().numpy()
    far = truth >= 256
    shares = {"raw_valid_share_truth_ge_256": float(valid[far].mean()),
              "raw_valid_share_truth_lt_256": float(valid[~far].mean()),
              "truth_ge_256_share": float(far.mean())}
    if not far.any() or (shares["raw_valid_share_truth_ge_256"]
                         < shares["raw_valid_share_truth_lt_256"] - LR_SHARE_GAP):
        raise AssertionError(f"3h LR check above 256 disparities: {shares}")
    return shares


def _middlebury_kernels(est, calibrated, errs_tag):
    """K1, K2, K3 (sgbm_3way's downward pass; above 256 disparities all
    four K3 passes, k3_passes), the WTA stage on sgbm_3way's S and,
    calibrated, the remap on the example's
    own pair at its shape: each equal to its plain version bit for bit,
    timed on the card (kernel and plain), with its bound. Drops the
    example's graphs first, and the facade's (their pools are GBs; a
    pipeline's reference cycles keep them until a collection). Returns
    {kernel: numbers}."""
    import dataclasses
    import gc

    from depthestimation_torch.ops import color, cuda_sgm, remap, wta

    core, cfg = est.core, est.core.cfg
    core._graph_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    gl, gr = core.left_rectified, core.right_rectified
    h, w = gl.shape
    d = cfg.num_disp
    errs, out = {}, {}

    def hold_and_time(name, kern, plain, **kw):
        """Hold kern() to plain() bit for bit, then time both, one at a
        time (a plain version at 1988x2964x288 takes tens of GB). Returns
        the kernel's output."""
        got = kern()
        hold_exact(f"{errs_tag} {name}", got, plain(), errs, "3h")
        ms_, plain_ms_ = time_ms(kern), time_ms(plain, runs=3)
        bound_ms, by = bound(*kernel_work(name, h, w, d, **kw))
        out[name] = {"shape": [h, w, d], "max_abs_err": errs[f"{errs_tag} {name}"],
                     "ms": ms_, "plain_ms": plain_ms_, "bound_ms": bound_ms, "bound_by": by}
        log(f"[3h] {errs_tag} {name}: {ms_:.4f} ms (bound {bound_ms:.4f}, {by}), "
            f"plain {plain_ms_:.2f} ms")
        torch.cuda.empty_cache()
        return got

    c = hold_and_time("cost_volume", lambda: cuda_sgm.cost_volume(gl, gr, cfg),
                      lambda: cuda_sgm.cost_volume_plain(gl, gr, cfg))
    swe = hold_and_time(cuda_sgm._hscan_name(d), lambda: cuda_sgm.hscan(c, cfg),
                        lambda: cuda_sgm.hscan_plain(c, cfg),
                        acc_bytes=cuda_sgm._acc_dtype(cfg).itemsize)
    if d > 256:
        passes = k3_passes(c, swe, cfg, dataclasses.replace(cfg, sgbm_mode="hh4"),
                           dataclasses.replace(cfg, sgbm_mode="hh"))
    else:  # sgbm_3way's pass only
        passes = {"rowsweep": (swe, cfg, (0,), False, cuda_sgm._final_dtype(cfg))}
    for name, (a, kcfg, dxs, rev, dt) in passes.items():
        hold_and_time(name, lambda: cuda_sgm.rowsweep(c, a, kcfg, dxs, rev, dt),
                      lambda: cuda_sgm.rowsweep_plain(c, a, kcfg, dxs, rev, dt),
                      acc_bytes=a.element_size(), out_bytes=dt.itemsize, dirs=len(dxs))
    del passes
    s = cuda_sgm.rowsweep(c, swe, cfg, (0,), False, cuda_sgm._final_dtype(cfg))
    del c, swe
    args = (cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff)
    hold_and_time("wta", lambda: wta.wta_disparity(s, *args),
                  lambda: wta.wta_disparity_plain(s, *args), acc_bytes=s.element_size())
    del s
    if calibrated:
        # The pair as prepare_rectified hands it to the remap: grayscale of
        # the downscaled images, resized back to the calibration's size.
        gray = torch.stack([color.resize_bilinear(color.to_grayscale(core._tensor(img)), (h, w))
                            for img in (est.left_source, est.right_source)])
        mx, my = core._rect_cache.device_maps(cfg.calib, cfg.baseline, 1.0, core.device)
        rect = hold_and_time("remap", lambda: remap.remap_bilinear(gray, mx, my),
                             lambda: remap.remap_bilinear_plain(gray, mx, my))
        if not (torch.equal(rect[0], gl) and torch.equal(rect[1], gr)):
            raise AssertionError(f"{errs_tag}: the remap of the resized pair is not the "
                                 "example's rectified pair")
    torch.cuda.empty_cache()
    return out


def phase_surface(smi):
    """examples.stereo on a written Middlebury-geometry PNG pair (without
    and with its calib.txt), examples.stereo_live, examples.mono,
    tools.profile_kernels, tools.halo_sweep, entry() and dryrun(1) (and
    dryrun(n) over n GPUs). Returns (the numbers to print, the Middlebury
    kernel numbers by shape)."""
    import torch.distributed as dist

    from depthestimation_torch import StereoDepthEstimator, parse_calib_file
    from depthestimation_torch import entry as entry_mod
    from depthestimation_torch.examples import mono, stereo, stereo_live
    from depthestimation_torch.io import png
    from depthestimation_torch.io.input import _area_downscale_np
    from depthestimation_torch.io.synthetic import (DEMO_CALIB, calib_text,
                                                    synthesize_stereo_pair, synthetic_stream)
    from depthestimation_torch.ops import cuda_sgm
    from depthestimation_torch.pipeline import StereoPipeline
    from depthestimation_torch.tools import halo_sweep, profile_kernels

    result = {"card": smi}
    kernels = {}

    # -- the pair: written as PNG, decoded back bit for bit --
    t0 = time.perf_counter()
    os.makedirs(SURFACE_DIR, exist_ok=True)
    paths = {name: os.path.join(SURFACE_DIR, name + ext)
             for name, ext in (("left", ".png"), ("right", ".png"), ("calib", ".txt"))}
    *written, gt = synthesize_stereo_pair(MIDDLEBURY["width"], MIDDLEBURY["height"],
                                          SCENE_NDISP, seed=0)
    for side, img in zip(("left", "right"), written):
        png.write_png(paths[side], img)
    with open(paths["calib"], "w") as fh:
        fh.write(calib_text(MIDDLEBURY))
    result["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [png.read_png(paths[side])[0] for side in ("left", "right")]
    result["decode_s"] = time.perf_counter() - t0
    for side, got, want in zip(("left", "right"), decoded, written):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"3h: the decoded {side} PNG differs from the array written")
    log(f"[3h] {MIDDLEBURY['width']}x{MIDDLEBURY['height']} pair written "
        f"({result['write_s']:.2f} s with the scene) and decoded ({result['decode_s']:.2f} s): "
        "equal to the arrays written, bit for bit")

    # -- examples.stereo at downscale 0.5 without and with calib.txt (D =
    # 144: the configured 280 halved and rounded up to a multiple of 16),
    # and at 1.0 without it (D = 288: K2 and K3's wide variants) --
    h_full, w_full, ndisp = MIDDLEBURY["height"], MIDDLEBURY["width"], MIDDLEBURY["ndisp"]
    half, full = -(-ndisp // 32) * 16, -(-ndisp // 16) * 16
    runs = {f"{h_full // 2}x{w_full // 2}x{half}": (0.5, ["--ndisp", str(ndisp)], False),
            f"{h_full}x{w_full}x{half}": (0.5, ["--calib", paths["calib"]], True),
            f"{h_full}x{w_full}x{full}": (1.0, ["--ndisp", str(ndisp)], False)}
    result["stereo"] = {}
    for tag, (factor, extra, calibrated) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        cuda_sgm.reset_launches()
        t0 = time.perf_counter()
        est = stereo.run([paths["left"], paths["right"], "--downscale", str(factor),
                          "--device", "cuda", "--no-viz", *extra])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        counts = counted()
        cfg = est.core.cfg
        d = cfg.num_disp
        expected = {"cost_volume": (1, 1), cuda_sgm._hscan_name(d): (1, 2),
                    cuda_sgm._rowsweep_name((0,), False, d): (1, 1),
                    **tail_counts(cfg, est.core.fast_mode)}
        if calibrated:
            expected["remap"] = (1, 1)
        log(f"[3h] examples.stereo {tag}: (calls, launches) {counts}")
        if counts != expected:
            raise AssertionError(f"examples.stereo {tag} made {counts}, expected {expected}")
        h, w = est.core.left_rectified.shape
        if f"{h}x{w}x{d}" != tag:
            raise AssertionError(f"examples.stereo {tag} matched at {h}x{w}x{d}")
        facade = StereoDepthEstimator(downscale_factor=factor, device="cuda")
        facade.left_source, facade.right_source = (_area_downscale_np(img, factor)
                                                   for img in decoded)
        if calibrated:
            facade.configure_sgbm(**parse_calib_file(paths["calib"])["sgbm_kwargs"],
                                  sgbm_mode="sgbm_3way")
        else:
            facade.configure_sgbm(num_disp=ndisp, sgbm_mode="sgbm_3way",
                                  focal_length=MIDDLEBURY["focal_px"],
                                  baseline=MIDDLEBURY["baseline_mm"] / 1000.0,
                                  doffs=MIDDLEBURY["doffs"])
        disp, depth = facade.estimate_depth()
        if not (np.array_equal(disp, est.disparity_map)
                and np.array_equal(depth, est.depth_map, equal_nan=True)):
            raise AssertionError(f"examples.stereo {tag} differs from the facade on the "
                                 "decoded arrays")
        del facade
        check_output(disp, depth, (h, w - d), tag)
        numbers = {"launches": {k: n for k, (_, n) in counts.items()},
                   "first_call_ms": first_ms, "ms_per_pair": host_ms(est.estimate_depth, runs=3),
                   "pool_bytes": sum(e.pool_bytes for e in est.core._graph_cache.values()),
                   "peak_allocated_bytes_first_call": peak,
                   "valid_share": float((disp > 0).mean())}
        if not calibrated:
            # The ground truth at the matcher's scale: k x k means over k.
            k = round(1 / factor)
            g = (gt.reshape(h, k, w, k).mean(axis=(1, 3)) / k)[:, d:]
            ok = disp > 0
            numbers["mae_px_vs_gt"] = float(np.abs(disp - g)[ok].mean())
            if d > 256:
                numbers.update(_lr_shares(est, g))
        log(f"[3h] examples.stereo {tag} == the facade on the decoded arrays (bit for bit): "
            f"{numbers}")
        result["stereo"][tag] = numbers
        kernels[tag] = _middlebury_kernels(est, calibrated, tag)
        for name in kernels[tag]:
            kernels[tag][name]["calls"], kernels[tag][name]["launches"] = counts.get(name,
                                                                                  (0, 0))
        del est
        torch.cuda.empty_cache()

    # -- examples.stereo_live: 60 synthetic frames at 0.7, no throttle --
    n_frames, first = 60, []
    cuda_sgm.reset_launches()
    vid = stereo_live.run(["--device", "cuda", "--no-viz", "--fps", "0",
                           "--frames", str(n_frames)],
                          on_frame=lambda i, depth: i < 3 and first.append(depth))
    torch.cuda.synchronize()
    counts = counted()
    expected = {"cost_volume": (n_frames, n_frames), "hscan": (n_frames, 2 * n_frames),
                "rowsweep": (n_frames, n_frames),
                **tail_counts(vid.core.cfg, vid.core.fast_mode, n_frames)}
    summary = vid.metrics.summary()
    if counts != expected or summary["frames"] != n_frames or summary["frames_failed"]:
        raise AssertionError(f"examples.stereo_live: {summary}, (calls, launches) {counts}")
    ref = StereoPipeline(downscale_factor=0.7, device="cuda")
    ref.configure(num_disp=DEMO_CALIB["ndisp"], focal_length=DEMO_CALIB["focal_px"],
                  baseline=DEMO_CALIB["baseline_mm"] / 1000.0, doffs=0,
                  hole_filling=True, temporal_alpha=0.4)
    for i, (left, right) in enumerate(zip(*synthetic_stream(3))):
        want = ref.estimate_depth(_area_downscale_np(left, 0.7), _area_downscale_np(right, 0.7))[1]
        if not np.array_equal(first[i], want):
            raise AssertionError(f"examples.stereo_live frame {i} differs from the single pair")
    result["stereo_live"] = dict(summary, launches={k: n for k, (_, n) in counts.items()})
    log(f"[3h] examples.stereo_live, {n_frames} frames at 0.7: frames 0-2 == the single-pair "
        f"path (bit for bit); {summary}")

    # -- examples.mono: small, the committed demo PNG at 0.5 --
    est = mono.run(["--device", "cuda", "--no-viz"])
    depth = est.depth_map
    if not (np.isfinite(depth).all() and (depth >= 0).all()):
        raise AssertionError("examples.mono: depth not finite and >= 0")
    result["mono"] = {"shape": list(depth.shape)}
    log(f"[3h] examples.mono: depth {depth.shape}, finite, >= 0")
    del est

    # -- tools.profile_kernels: the hh4 1080p/128 stage table --
    rows = profile_kernels.profile(verbose=False)
    log("[3h] tools.profile_kernels (hh4, 1080x1920x128):\n" + profile_kernels.table(rows))
    result["profile_kernels"] = {name: [ms_, host] for name, ms_, host in rows}

    # -- tools.halo_sweep: 1080p, 128 disparities, 8 tiles --
    sweep = halo_sweep.sweep(H, W, D, 8, device="cuda", verbose=False)
    log("[3h] tools.halo_sweep (hh4, 1080x1920x128, 8 tiles):\n" + halo_sweep.table(sweep))
    result["halo_sweep"] = {f"speckle {s} halo {h}": list(v) for (s, h), v in sweep.items()}
    bad = {k: v for k, v in sweep.items() if k[0] == 0 and k[1] >= 64 and v[1] >= 0.5}
    if bad:
        raise AssertionError(f"halo_sweep: seam mismatch >= 0.5 % at {bad}")

    # -- the entry module: entry()'s function, then dryrun(1) over NCCL --
    fn, args = entry_mod.entry()
    disp = fn(*args)
    torch.cuda.synchronize()
    if tuple(disp.shape) != (270, 416) or not disp.is_cuda or not torch.isfinite(disp).all():
        raise AssertionError(f"entry(): disparity {tuple(disp.shape)} on {disp.device}")
    result["dryrun_1"] = entry_mod.dryrun(1)
    if result["dryrun_1"]["backend"] != "nccl" or dist.is_initialized():
        raise AssertionError(f"dryrun(1): {result['dryrun_1']}")
    n_gpus = torch.cuda.device_count()
    result["dryrun_n"] = n_gpus if n_gpus > 1 else None
    if n_gpus > 1:
        entry_mod.dryrun(n_gpus)
    log(f"[3h] entry(): disparity {tuple(disp.shape)} on the card; dryrun(1) over NCCL "
        f"passed: {result['dryrun_1']}" + (f"; dryrun({n_gpus}), one process per GPU, "
                                           "passed" if n_gpus > 1 else ""))
    return result, kernels


# ---- 3j. above 256 disparities, and the float32 route ----
# (h, w, D, shift) of phase 2's wide holds: a last chunk of 16 disparities
# (272 = 256 + 16) and four whole chunks (1024).
WIDE_HOLDS = ((64, 400, 272, 260), (24, 1100, 1024, 700))


def wide_holds(errs):
    """Phase 2 above 256 disparities: K1 (BT and census), K2 and K3's four
    passes (k3_passes: sgbm_3way's, hh4's, hh's three-direction ones) equal
    to their plain versions on integer texture pairs at WIDE_HOLDS, through
    the wide variants of K2 and K3. Returns {kernel: {shape: max_abs_err}}."""
    from depthestimation_torch import SGMConfig
    from depthestimation_torch.ops import cuda_sgm

    by_kernel = {}

    def hold(tag, name, got, want):
        hold_exact(f"{tag} {name}", got, want, errs)
        by_kernel.setdefault(name, {})[tag] = errs[f"{tag} {name}"]

    for h, w, d, shift in WIDE_HOLDS:
        left, right = (torch.tensor(img[..., 0], dtype=torch.float32, device="cuda")
                       for img in texture_pair(h, w, shift, seed=d))
        cfg, cfgc = SGMConfig(num_disp=d), SGMConfig(num_disp=d, cost="census")
        tag = f"{h}x{w}x{d}"
        c = cuda_sgm.cost_volume(left, right, cfg)
        hold(tag, "cost_volume", c, cuda_sgm.cost_volume_plain(left, right, cfg))
        hold(tag, "cost_volume_census", cuda_sgm.cost_volume(left, right, cfgc),
             cuda_sgm.cost_volume_plain(left, right, cfgc))
        swe = cuda_sgm.hscan(c, cfg)
        hold(tag, cuda_sgm._hscan_name(d), swe, cuda_sgm.hscan_plain(c, cfg))
        passes = k3_passes(c, swe, cfg, SGMConfig(num_disp=d, sgbm_mode="hh4"),
                           SGMConfig(num_disp=d, sgbm_mode="hh"))
        for name, (acc, kcfg, dxs, rev, dt) in passes.items():
            hold(tag, name, cuda_sgm.rowsweep(c, acc, kcfg, dxs, rev, dt),
                 cuda_sgm.rowsweep_plain(c, acc, kcfg, dxs, rev, dt))
    return by_kernel


# bench.py's hh_8path_1080p_256d (bench.py:562-566: hh, no speckle, fast
# mode), at D = 256 (the narrow K2 and K3) and 272 (their wide variants).
SWITCH_DISPS = (256, 272)


def _switch_sides(counts_of):
    """bench.py's hh_8path_1080p_256d on phase 3's 1080p pair (the known
    20 px shift) at each of SWITCH_DISPS, each side of the switch to the
    wide K2 and K3: a pair through StereoDepthEstimator launches exactly
    the path's kernels and recovers the shift on >= 95 %; K2 and hh's
    two K3 passes on that pair equal their plain versions bit for bit and
    are timed. Returns {D: numbers}."""
    from depthestimation_torch import StereoDepthEstimator
    from depthestimation_torch.ops import cuda_sgm

    left_rgb, right_rgb = texture_pair(H, W, SHIFT, seed=0)
    out = {}
    for d in SWITCH_DISPS:
        path = f"j hh 1080p {d}"
        k2, down, up = (cuda_sgm._hscan_name(d), cuda_sgm._rowsweep_name((0, 1, -1), False, d),
                        cuda_sgm._rowsweep_name((0, -1, 1), True, d))
        est = StereoDepthEstimator(device="cuda")
        est.left_source, est.right_source = left_rgb, right_rgb
        est.configure_sgbm(num_disp=d, focal_length=1000.0, baseline=0.1, sgbm_mode="hh",
                           speckle_window_size=0)
        est.core.fast_mode = True
        disp, depth = drive(est, counts_of, path, {"cost_volume": (1, 1), k2: (1, 2),
                                                  down: (1, 3), up: (1, 3),
                                                  **tail_counts(est.core.cfg, True)})
        check_output(disp, depth, (H, W - d), path)
        hit = float((np.abs(disp - SHIFT) <= 1.0).mean())
        if hit < 0.95:
            raise AssertionError(f"{path}: known shift on {hit:.4%} of pixels")
        numbers = {"shift_hit": hit, "ms_per_pair": host_ms(est.estimate_depth, runs=3)}
        # The kernels on the pair as the matcher got it; the graph's pool
        # goes first (GBs).
        cfg, gl, gr = est.core.cfg, est.core.left_rectified, est.core.right_rectified
        est.core._graph_cache.clear()
        torch.cuda.empty_cache()
        acc, final = cuda_sgm._acc_dtype(cfg), cuda_sgm._final_dtype(cfg)
        c = cuda_sgm.cost_volume(gl, gr, cfg)
        swe = cuda_sgm.hscan(c, cfg)
        s5 = cuda_sgm.rowsweep(c, swe, cfg, (0, 1, -1), False, acc)
        errs = {}
        hold_exact(f"{path} {k2}", swe, cuda_sgm.hscan_plain(c, cfg), errs, "3j")
        hold_exact(f"{path} {down}", s5,
                   cuda_sgm.rowsweep_plain(c, swe, cfg, (0, 1, -1), False, acc), errs, "3j")
        hold_exact(f"{path} {up}", cuda_sgm.rowsweep(c, s5, cfg, (0, -1, 1), True, final),
                   cuda_sgm.rowsweep_plain(c, s5, cfg, (0, -1, 1), True, final), errs, "3j")
        timed = {k2: lambda: cuda_sgm.hscan(c, cfg),
                 down: lambda: cuda_sgm.rowsweep(c, swe, cfg, (0, 1, -1), False, acc),
                 up: lambda: cuda_sgm.rowsweep(c, s5, cfg, (0, -1, 1), True, final)}
        numbers["kernels"] = {name: {"ms": time_ms(kern), "max_abs_err": errs[f"{path} {name}"],
                                     "launches": counts_of[path][name][1]}
                              for name, kern in timed.items()}
        log(f"[3j] {path} (hh_8path_1080p_256d's flags): known {SHIFT} px shift on {hit:.4%}; "
            f"{k2}, {down} and {up} == plain versions (exact); {numbers}")
        out[d] = numbers
        del est, c, swe, s5, timed
        torch.cuda.empty_cache()
    return out


def phase_wide(counts_of):
    """The hh4 and hh paths at D = 288 (examples.stereo's D at downscale
    1.0) through StereoDepthEstimator on a 240x720 texture pair moved by
    270 px, north-star flags: each pair launches exactly the wide variants
    of its path, recovers the shift on >= 95 % of the pixels, and its raw
    disparity equals the plain-composed one. Then bench.py's
    hh_8path_1080p_256d at D = 256 and 272 (_switch_sides). Then the float32 route (BT at
    block size 15, past the int16 bounds, D = 64 at 256x640): the facade's
    first call captures its graph, a replay equals the eager functions bit
    for bit and counts one float32_route call and no matcher launch but the
    WTA kernel's (and the speckle filter's), raw_disparity
    on the card equals the CPU's, and above 1 << 26 cells it raises
    ValueError before anything runs. Returns the numbers to print."""
    from depthestimation_torch import SGMConfig, StereoDepthEstimator
    from depthestimation_torch import pipeline
    from depthestimation_torch.ops import cuda_sgm

    result = {}
    d, shift = 288, 270
    left_rgb, right_rgb = texture_pair(240, 720, shift, seed=5)
    for path, mode, expected in (
            ("j hh4 288", "hh4", {"cost_volume": (1, 1), "hscan_wide": (1, 2),
                                  "rowsweep_wide": (1, 1), "rowsweep_wide_up": (1, 1),
                                  "wta": (1, 1)}),
            ("j hh 288", "hh", {"cost_volume": (1, 1), "hscan_wide": (1, 2),
                                "rowsweep_wide_diag": (1, 3), "rowsweep_wide_diag_up": (1, 3),
                                "wta": (1, 1)})):
        est = StereoDepthEstimator(device="cuda")
        est.left_source, est.right_source = left_rgb, right_rgb
        est.configure_sgbm(num_disp=d, focal_length=1000.0, baseline=0.1, sgbm_mode=mode,
                           **NORTH_STAR)
        est.core.fast_mode = True
        disp, depth = drive(est, counts_of, path, expected)
        check_output(disp, depth, (240, 720 - d), path)
        hit = float((np.abs(disp - shift) <= 1.0).mean())
        gl, gr = est.core.left_rectified, est.core.right_rectified
        if hit < 0.95 or not torch.equal(
                pipeline.raw_disparity(gl, gr, est.core.cfg),
                pipeline.raw_disparity(gl, gr, est.core.cfg,
                                       matcher=cuda_sgm.sgm_disparity_plain)):
            raise AssertionError(f"{path}: shift on {hit:.4%}, or kernels != plain")
        result[mode] = {"shift_hit": hit}
        log(f"[3j] {path}: known {shift} px shift on {hit:.4%}; raw disparity: kernels == "
            "plain versions on the card (exact)")
        del est

    result["hh_8path_1080p"] = _switch_sides(counts_of)

    kw = dict(num_disp=64, block_size=15)
    left_rgb, right_rgb = texture_pair(256, 640, 9, seed=6)
    est = StereoDepthEstimator(device="cuda")
    est.left_source, est.right_source = left_rgb, right_rgb
    est.configure_sgbm(focal_length=1000.0, baseline=0.1, **kw)
    cfg = est.core.cfg
    if cuda_sgm.kernels_supported(cfg, (256, 640)):
        raise AssertionError(f"{kw} is inside the kernels' bounds")
    cuda_sgm.reset_launches()
    est.estimate_depth()  # eager once, captured, instantiated
    torch.cuda.synchronize()
    (entry,) = est.core._graph_cache.values()
    cuda_sgm.reset_launches()
    disp, depth = est.estimate_depth()  # a replay
    torch.cuda.synchronize()
    counts = counted()
    if (counts != tail_counts(cfg, est.core.fast_mode) or cuda_sgm.CALLS["float32_route"] != 1
            or entry.replays < 1):
        raise AssertionError(f"float32 route replay: (calls, launches) {counts}, "
                             f"{cuda_sgm.CALLS['float32_route']} float32_route calls")
    gl, gr = est.core.left_rectified, est.core.right_rectified
    want = pipeline.stereo_depth_fn(gl, gr, cfg)
    if not (np.array_equal(disp, want[0].cpu().numpy())
            and np.array_equal(depth, want[1].cpu().numpy(), equal_nan=True)):
        raise AssertionError("float32 route: the graph's replay differs from the eager pair")
    raw = pipeline.raw_disparity(gl, gr, cfg)
    if not torch.equal(raw.cpu(), pipeline.raw_disparity(gl.cpu(), gr.cpu(), cfg)):
        raise AssertionError("float32 route: card raw disparity differs from the CPU's")
    big = torch.zeros((1024, 1040), device="cuda")  # 1024 * 1040 * 64 > 1 << 26
    try:
        pipeline.raw_disparity(big, big, cfg)
    except ValueError as e:
        if "too large for the float32 matcher" not in str(e):
            raise
    else:
        raise AssertionError("float32 route above 1 << 26 cells on the card did not raise")
    result["float32_route"] = {"shape": [256, 640, 64], "block_size": 15,
                               "valid_share": float((disp > 0).mean()),
                               "first_call": _graph_numbers(entry),
                               "ms_per_pair": host_ms(est.estimate_depth, runs=3)}
    log(f"[3j] float32 route (BT block 15, 256x640x64): replay == eager (bit for bit), one "
        "float32_route call and no matcher launch but the WTA kernel's a pair, card == CPU; "
        "1024x1040x64 raised "
        f"ValueError on the card; {result['float32_route']}")
    return result


# ---- 3i. the compiled-program caches as CUDA graphs ----


def _graph_numbers(entry):
    """A CapturedCall's first-use numbers."""
    return {"warmup_ms": entry.warmup_ms, "capture_ms": entry.capture_ms,
            "instantiate_ms": entry.instantiate_ms, "pool_bytes": entry.pool_bytes}


def _split_numbers(split):
    return {k: split[k] for k in ("host_ms", "host_behind_sleep_ms", "device_events_ms",
                                  "kernel_ms", "span_ms", "kernels", "card_idle_share")}


def _hold_same(tag, got, want):
    for name, g, w in zip(("disparity", "depth"), got, want):
        if (g is None) != (w is None) or (g is not None and not (
                g.dtype == w.dtype and torch.equal(g, w))):
            raise AssertionError(f"3i {tag}: the graphed {name} differs from the eager one")


def graph_cell(tag, core, left, right, cycles_per_ms, expected=None):
    """One stereo cell with graphs: the first estimate_depth_async (warm-up
    and capture, timed) and a replay equal bit for bit to the eager
    pipeline on the same raw pair (already on the card), the replay's
    (calls, launches) equal to the eager pair's (and to `expected`, phase
    3's, where given); then eager against graphed: host enqueue, kernel
    ms, idle share (host_device_split) and ms per pair with the read-back;
    the peak of allocated device memory over the cell (the graph's pool
    beside the eager pair's working set). Returns the numbers to print."""
    from depthestimation_torch.ops import cuda_sgm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = core.estimate_depth_async(left, right)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    (entry,) = core._graph_cache.values()
    cuda_sgm.reset_launches()
    want = eager_pair(core, left, right)
    torch.cuda.synchronize()
    eager_counts = counted()
    cuda_sgm.reset_launches()
    got = core.estimate_depth_async(left, right)
    torch.cuda.synchronize()
    counts = counted()
    if counts != eager_counts or (expected is not None and counts != expected):
        raise AssertionError(f"3i {tag}: a replay made (calls, launches) {counts}, the eager "
                             f"pair {eager_counts}, phase 3 {expected}")
    _hold_same(tag, got, want)
    _hold_same(tag + " (first call)", first, want)
    del first, got, want

    def read(out):
        return [t.cpu() for t in out if t is not None]

    out = {"shape": list(left.shape), "num_disp": core.cfg.num_disp,
           "counts": counts, "first_call_ms": first_ms, **_graph_numbers(entry),
           "eager": _split_numbers(host_device_split(lambda: eager_pair(core, left, right),
                                                     cycles_per_ms)),
           "graphed": _split_numbers(host_device_split(
               lambda: core.estimate_depth_async(left, right), cycles_per_ms)),
           "eager_ms_per_pair": host_ms(lambda: read(eager_pair(core, left, right))),
           "graphed_ms_per_pair": host_ms(lambda: read(core.estimate_depth_async(left, right)))}
    out["profiler_sees_replay"] = out["graphed"]["kernels"] > 0
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[3i] {tag}: replay == eager (bit for bit), (calls, launches) {counts}; {out}")
    return out


def phase_graphs(pair, raw_pair, counts_of, cycles_per_ms, smi):
    """The graphs against the eager functions: the stereo cells of phase 3
    and both Middlebury shapes of 3h (graph_cell), a temporal sequence with
    a reset, the injected-matcher seam, and the mono `small` forward at
    518x518. Returns the numbers to print."""
    import gc

    from depthestimation_torch import parse_calib_file
    from depthestimation_torch.io import png
    from depthestimation_torch.io.input import _area_downscale_np
    from depthestimation_torch.models.mono import MonoDepthModel, preprocess_image
    from depthestimation_torch.ops import cuda_sgm
    from depthestimation_torch.pipeline import (StereoPipeline, postprocess_and_depth,
                                                raw_disparity)

    dev = torch.device("cuda")
    result = {"card": smi}

    def on_card(imgs):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in imgs]

    def pipe(cfg_kw, fast, downscale=1.0):
        core = StereoPipeline(downscale_factor=downscale, fast_mode=fast, device="cuda")
        core.configure(**cfg_kw)
        return core

    base = dict(num_disp=D, focal_length=1000.0, baseline=0.1)
    rig = dict(num_disp=D, sgbm_mode="hh4", **NORTH_STAR, **mild_rig(H, W))
    left, right = on_card(pair)
    raw_l, raw_r = on_card(raw_pair)
    cells = {
        "default": (base, False, (left, right), "a default"),
        "north_star": (dict(base, **NORTH_STAR), True, (left, right), None),
        "rectified_hh4": (rig, True, (raw_l, raw_r), "b rectified"),
        "hh": (dict(base, sgbm_mode="hh", **NORTH_STAR), True, (left, right), "c hh"),
        "census": (dict(base, cost="census", **NORTH_STAR), True, (left, right), "c census"),
    }
    result["cells"] = {}
    for tag, (kw, fast, (cl, cr), path) in cells.items():
        core = pipe(kw, fast)
        result["cells"][tag] = graph_cell(tag, core, cl, cr, cycles_per_ms,
                                          counts_of.get(path))
        del core
        gc.collect()
        torch.cuda.empty_cache()

    # -- the Middlebury shapes of 3h: the example's pair, downscaled 0.5 --
    paths = {side: os.path.join(SURFACE_DIR, side + ".png") for side in ("left", "right")}
    small = on_card([_area_downscale_np(png.read_png(paths[side])[0], 0.5)
                     for side in ("left", "right")])
    mid = dict(num_disp=MIDDLEBURY["ndisp"], sgbm_mode="sgbm_3way",
               focal_length=MIDDLEBURY["focal_px"], baseline=MIDDLEBURY["baseline_mm"] / 1000.0,
               doffs=MIDDLEBURY["doffs"])
    calib = dict(parse_calib_file(os.path.join(SURFACE_DIR, "calib.txt"))["sgbm_kwargs"],
                 sgbm_mode="sgbm_3way")
    h_full, w_full = MIDDLEBURY["height"], MIDDLEBURY["width"]
    for tag, kw, remap_ in ((f"middlebury_{h_full // 2}x{w_full // 2}x144", mid, False),
                            (f"middlebury_{h_full}x{w_full}x144", calib, True)):
        core = pipe(kw, False, downscale=0.5)
        expected = {"cost_volume": (1, 1), "hscan": (1, 2), "rowsweep": (1, 1),
                    **tail_counts(core.cfg, False)}
        if remap_:
            expected["remap"] = (1, 1)
        result["cells"][tag] = graph_cell(tag, core, *small, cycles_per_ms, expected)
        del core
        gc.collect()
        torch.cuda.empty_cache()
    del small

    # -- a temporal sequence with a reset: the live smoother on the rig --
    core = pipe(dict(rig, **LIVE), False)
    frames = list(zip(*drifted(raw_pair, 3)))
    prev, keys = None, []
    for i, (fl, fr) in enumerate(frames):
        if i == 2:
            core.reset_temporal()
            prev = None
        fl, fr = on_card((fl, fr))
        got = core.estimate_depth_async(fl, fr)
        want = eager_pair(core, fl, fr, prev)
        prev = want[0]
        _hold_same(f"temporal frame {i}", got, want)
    keys = sorted(k[-1] for k in core._graph_cache)
    if keys != [False, True]:
        raise AssertionError(f"3i temporal: entries {keys}")
    result["temporal"] = {"frames": 3, "reset_before": 2, "entries": len(keys), "equal": True}
    log("[3i] temporal sequence (rectified rig, hole filling, temporal 0.4), 3 frames "
        "with a reset before the third: == the eager chain (bit for bit)")
    del core, got, want, prev

    # -- the injected-matcher seam: the kernels' matcher eagerly, the tail replayed --
    core = pipe(base, False)
    core.compute_disparity = lambda l, r: raw_disparity(l, r, core.cfg)
    gl, gr = core.prepare_rectified(left, right)
    for i in range(3):
        cuda_sgm.reset_launches()
        got = core.process_pair_async(gl, gr)
        torch.cuda.synchronize()
        counts = counted()
        want = postprocess_and_depth(raw_disparity(gl, gr, core.cfg), core.cfg, guide=gl)
        _hold_same(f"injected matcher, pair {i}", got, want)
        if counts != counts_of["a default"]:
            raise AssertionError(f"3i injected matcher: (calls, launches) {counts}")
    (entry,) = core._graph_cache.values()
    result["injected_matcher"] = {"equal": True, "replays": entry.replays,
                                  **_graph_numbers(entry)}
    log(f"[3i] injected matcher: the tail replayed {entry.replays} times, == eager "
        f"(bit for bit); {result['injected_matcher']}")
    del core, entry, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # -- the mono net: `small` at 518x518 through predict_async --
    model = MonoDepthModel.create("small", seed=0, device=dev)
    img = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (518, 518, 3), dtype=np.uint8)).to(dev)

    def eager_predict():
        with torch.inference_mode():
            return model.net(preprocess_image(img, device=dev)[None])[0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.predict_async(img)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    got = model.predict_async(img)
    want = eager_predict()
    err = float((got - want).abs().max() / want.abs().max())
    (entry,) = model._graph_cache.values()
    mono = {"shape": [1, 518, 518, 3], "first_call_ms": first_ms, **_graph_numbers(entry),
            "rel_err_vs_eager": err, "tolerance": MONO_GRAPH_TOL,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "eager": _split_numbers(host_device_split(eager_predict, cycles_per_ms, runs=5)),
            "graphed": _split_numbers(host_device_split(lambda: model.predict_async(img),
                                                        cycles_per_ms, runs=5)),
            "eager_ms": host_ms(lambda: eager_predict().cpu(), runs=11),
            "graphed_ms": host_ms(lambda: model.predict_async(img).cpu(), runs=11)}
    mono["profiler_sees_replay"] = mono["graphed"]["kernels"] > 0
    log(f"[3i] mono small 518: graphed vs eager max abs err / max {err:.3e} "
        f"(tolerance {MONO_GRAPH_TOL}); {mono}")
    if not err <= MONO_GRAPH_TOL:
        raise AssertionError("3i mono: the graphed forward differs from the eager one")
    result["mono_small_518"] = mono
    del model, entry
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main_tensor_parallel() -> int:
    """Phase 3g's checks with one process per GPU alone, on four GPUs or
    more: _multi_gpu_rank's, then phase_tensor_parallel against phase
    3f's one-rank step (_train_run at mesh (1, 1, 1) on GPU 0)."""
    from depthestimation_torch.models.mono import MonoDepthModel
    from depthestimation_torch.parallel.mesh import destroy_process_group, make_mesh
    from depthestimation_torch.tools import profile_kernels

    world = 1 << (max(torch.cuda.device_count(), 1).bit_length() - 1)
    smi = smi_line()
    log(f"[3g] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | {smi}")
    if world < 4:
        log(f"chip_smoke --tensor-parallel: needs four GPUs, found {world}")
        return 1
    _spawn_multi_gpu(world)
    cycles_per_ms = profile_kernels.sleep_cycles_per_ms()
    mesh = make_mesh((1, 1, 1))
    net = MonoDepthModel.create("small", seed=0, image_size=TRAIN_HW, device="cpu").net
    one_rank = _train_run(net, mesh, *_train_data(), cycles_per_ms)
    destroy_process_group()
    print(json.dumps({"tensor_parallel": phase_tensor_parallel(world, cycles_per_ms,
                                                               one_rank)}))
    print(smi)
    return 0


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace-dir", default=None,
                        help="write phase 3d's profiler traces (Chrome JSON) here")
    parser.add_argument("--tensor-parallel", action="store_true",
                        help="run only phase 3g's checks with one process per GPU (four "
                             "GPUs or more): batch_pipeline whole and in row tiles, then "
                             "the tensor-parallel check against the one-rank step; print "
                             "its JSON line")
    args = parser.parse_args()
    trace_dir = args.trace_dir
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    if args.tensor_parallel:
        return main_tensor_parallel()
    import torch.nn.functional as F

    from depthestimation_torch import StereoDepthEstimator, SGMConfig
    from depthestimation_torch import pipeline
    from depthestimation_torch.calib import RectificationCache
    from depthestimation_torch.ops import (cuda_build, cuda_sgm, filters,
                                           remap, wta)
    from depthestimation_torch.tools import profile_kernels

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
    wide_errs = wide_holds(errs)
    # The WTA stage on the default's S (sgbm_3way's final sum).
    s_default = k3_out["rowsweep"]
    wta_args = (cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff)
    hold_exact("wta", wta.wta_disparity(s_default, *wta_args),
               wta.wta_disparity_plain(s_default, *wta_args), errs)
    # The speckle filter on the matcher's raw disparity with speckle off:
    # the matcher's call (window 50, new_val min_disp - 1, the whole map)
    # and the postprocess's (window 100, new_val 0, the crop's strided view).
    raw = pipeline.raw_disparity(gl, gr, cfg.updated(speckle_window_size=0))
    speckle = {"speckle": (raw, float(cfg.min_disp - 1), cfg.speckle_window_size),
               "speckle_post": (raw[:, D:], 0.0, 100)}
    for name, (x, new_val, window) in speckle.items():
        hold_exact(name, filters.filter_speckles(x, new_val, window, 1.0),
                   filters.filter_speckles_plain(x, new_val, window, 1.0), errs)
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
    for name, args in speckle.items():
        timed[name] = (lambda a=args: filters.filter_speckles(*a, 1.0),
                       lambda a=args: filters.filter_speckles_plain(*a, 1.0))
    timed["wta"] = (lambda: wta.wta_disparity(s_default, *wta_args),
                    lambda: wta.wta_disparity_plain(s_default, *wta_args))
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

    # Least time for the same work (kernel_work, bound).
    acc_b = swe.element_size()
    work = {name: kernel_work(name, H, W, D, acc_bytes=acc_b)
            for name in ("cost_volume", "cost_volume_census", "hscan", "remap")}
    for name, (acc, _, dxs, _, _) in k3.items():
        work[name] = kernel_work(name, H, W, D, acc.element_size(),
                                 k3_out[name].element_size(), len(dxs))
    work["speckle"] = kernel_work("speckle", H, W, D)
    work["speckle_post"] = kernel_work("speckle", H, W - D, D)
    work["wta"] = kernel_work("wta", H, W, D, acc_bytes=s_default.element_size())
    del k3, k3_out, cc, raw, speckle, s_default

    # ---- 3a. default path through the user's entry point ----
    counts_of = {}
    est = StereoDepthEstimator(device="cuda")
    est.left_source, est.right_source = left_rgb, right_rgb
    est.configure_sgbm(num_disp=D, focal_length=1000.0, baseline=0.1)
    disp, depth = drive(est, counts_of, "a default",
                        {"cost_volume": (1, 1), "hscan": (1, 2),
                         "rowsweep": (1, 1), "wta": (1, 1), "speckle": (2, 8)})
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
    cycles_per_ms = profile_kernels.sleep_cycles_per_ms()
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
                         "rowsweep_up": (1, 1), "wta": (1, 1)})
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
              "rowsweep_diag": (1, 3), "rowsweep_diag_up": (1, 3), "wta": (1, 1)}),
            ("c census", dict(cost="census"),
             {"cost_volume_census": (1, 1), "hscan": (1, 2),
              "rowsweep": (1, 1), "wta": (1, 1)})):
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

    # Each pipeline holds its CUDA graphs' pools; phase 3i makes its own.
    del est, ns, rest, e
    torch.cuda.empty_cache()

    # ---- 3d. streaming through StereoDepthEstimatorVideo ----
    streams = phase_streaming((raw_l, raw_r), cycles_per_ms, trace_dir)

    # ---- 3e. the monocular net and MonocularDepthEstimator ----
    mono_numbers = phase_mono(cycles_per_ms, smi)

    # ---- 3f. the mono training step; 3g. the parallel layer ----
    from depthestimation_torch.parallel.mesh import destroy_process_group

    mesh, train_numbers = phase_train(cycles_per_ms, smi)
    parallel_numbers = phase_parallel(mesh, cycles_per_ms, train_numbers)
    destroy_process_group()

    # ---- 3h. examples, tools and entry points on the card ----
    surface_numbers, middlebury = phase_surface(smi)

    # ---- 3j. the wide variants' paths and the float32 route ----
    wide_numbers = phase_wide(counts_of)

    # ---- 3i. the CUDA graphs against the eager functions ----
    graph_numbers = phase_graphs((left_rgb, right_rgb), (raw_l, raw_r), counts_of,
                                 cycles_per_ms, smi)

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
        ("speckle", "depthestimation_torch/csrc/speckle_kernels.cu",
         "none (plain XLA: depthestimation_tpu/ops/filters.py:117)", "a default"),
        ("wta", "depthestimation_torch/csrc/wta_kernels.cu",
         "none (plain XLA: depthestimation_tpu/ops/wta.py:86)", "a default"),
    ]
    kernels = []
    for name, source, replaces, path in kernel_rows:
        calls, launches = counts_of[path].get(name, (0, 0))
        bound_ms, bound_by = bound(*work[name])
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path.split()[1], "calls": calls,
            "launches": launches,
            "max_abs_err": errs[name], "exact": errs[name] == 0,
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(name),
        }
        row["loss_ms"] = row["calls"] * (row["ms"] - row["bound_ms"])
        if name == "speckle":
            # The pair's second call: the postprocess's, window 100 on the crop.
            post = bound(*work["speckle_post"])[0]
            row.update(ms_post=ms["speckle_post"], plain_ms_post=plain_ms["speckle_post"],
                       bound_ms_post=post, max_abs_err_post=errs["speckle_post"])
            row["loss_ms"] = row["ms"] - row["bound_ms"] + row["ms_post"] - post
        # Launches in phase 3g's batch_pipeline over 4 frames (its own path).
        row["launches_batch_pipeline"] = parallel_numbers["batch_pipeline_counts"].get(
            name, (0, 0))[1]
        if name == "cost_volume":
            row["max_abs_err_fractional"] = errs["cost_volume_fractional"]
        # Phase 3h: launches in examples.stereo's run at each Middlebury
        # shape, ms, plain ms, bound and error at that shape.
        row["middlebury"] = {tag: by_name[name] for tag, by_name in middlebury.items()
                             if name in by_name}
        row["max_abs_err_wide"] = wide_errs.get(name, {})
        kernels.append(row)
    # K2 and K3's wide variants, their numbers from examples.stereo's
    # 1988x2964x288 run in phase 3h (ms, plain ms, bound, error at that
    # shape; K2 and K3's downward pass are that run's, counted in it), the
    # other passes' calls and launches from phase 3j's hh4 and hh paths.
    full = middlebury[f"{MIDDLEBURY['height']}x{MIDDLEBURY['width']}x288"]
    for name, path in (("hscan_wide", None), ("rowsweep_wide", None),
                       ("rowsweep_wide_up", "j hh4 288"), ("rowsweep_wide_diag", "j hh 288"),
                       ("rowsweep_wide_diag_up", "j hh 288")):
        at = full[name]
        calls, launches = ((at["calls"], at["launches"]) if path is None
                           else counts_of[path].get(name, (0, 0)))
        row = {"name": name, "route": "cuda", "source": sgm_src,
               "replaces": "depthestimation_tpu/ops/pallas_sgm.py:"
                           + ("501" if name.startswith("hscan") else "595"),
               "path": "middlebury_288" if path is None else path.split()[1] + "_288",
               "calls": calls, "launches": launches,
               "max_abs_err": at["max_abs_err"], "exact": at["max_abs_err"] == 0,
               "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
               "bound_by": at["bound_by"], "library_ms": None, "shape": at["shape"],
               "max_abs_err_wide": wide_errs[name]}
        row["loss_ms"] = calls * (row["ms"] - row["bound_ms"])
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"streams": streams, "stages": split}))
    print(json.dumps({"wide": wide_numbers}))
    print(json.dumps({"mono": mono_numbers}))
    print(json.dumps({"train": train_numbers, "parallel": parallel_numbers}))
    print(json.dumps({"surface": surface_numbers}))
    print(json.dumps({"graphs": graph_numbers}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
