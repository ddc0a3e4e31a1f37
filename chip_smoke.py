"""Drive the PyTorch port's stereo path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name and power limit; build the CUDA kernels from
     depthestimation_torch/csrc and report the build time;
  2. kernels: K1 cost_volume, K2 hscan and K3 rowsweep against their plain
     PyTorch versions at 1080x1920, num_disp=128 (default config), bit
     exact, each timed with CUDA events (median of 7 after a warm-up);
  3. end to end: StereoDepthEstimator(device="cuda").estimate_depth() on a
     seeded 1080x1920 RGB texture pair with a known 20 px shift, with the
     kernel launch counts set to 0 just before and read just after; the
     kernel-composed raw disparity against the plain-composed one on the
     card; the known shift on >= 95 % of pixels; the card against the CPU
     on a small pair; median ms per pair for the default (full
     postprocess) and the north-star (no speckle, WLS, fast mode) configs,
     and the device time of each stage of a pair;
  4. one JSON line {"kernels": [...]} with launches, times and bounds;
  5. the card's name and power limit, then the last line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or depthestimation_tpu.
"""

from __future__ import annotations

import json
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


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def texture_pair(h, w, shift, seed):
    """RGB uint8 pair: a smoothed multi-scale random texture, and the same
    texture moved so that left[x] == right[x - shift]."""
    rng = np.random.default_rng(seed)
    tw = w + shift
    tex = np.zeros((h, tw), np.float32)
    for scale in (1, 2, 4, 8):
        low = rng.normal(0, 1, (h // scale + 1, tw // scale + 1)).astype(np.float32)
        tex += np.kron(low, np.ones((scale, scale), np.float32))[:h, :tw]
    tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)) / 3.0
    tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255.0).astype(np.uint8)
    left, right = tex[:, :w], tex[:, shift:]
    return (np.repeat(left[..., None], 3, -1).copy(),
            np.repeat(right[..., None], 3, -1).copy())


def time_ms(fn, runs=7) -> float:
    """Median milliseconds of fn() on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    from depthestimation_torch import StereoDepthEstimator, SGMConfig
    from depthestimation_torch import pipeline
    from depthestimation_torch.ops import costs, cuda_build, cuda_sgm, filters, wta

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] device: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_build.load_library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("    ptxas:", line.strip())

    # ---- 2. kernels against their plain versions, 1080x1920x128 ----
    cfg = SGMConfig(num_disp=D)
    left_rgb, right_rgb = texture_pair(H, W, SHIFT, seed=0)
    gl = torch.tensor(left_rgb[..., 0], dtype=torch.float32, device=dev)
    gr = torch.tensor(right_rgb[..., 0], dtype=torch.float32, device=dev)

    c = cuda_sgm.cost_volume(gl, gr, cfg)
    swe = cuda_sgm.hscan(c, cfg)
    s = cuda_sgm.rowsweep(c, swe, cfg)
    torch.cuda.synchronize()
    checks = {
        "cost_volume": (c, cuda_sgm.cost_volume_plain(gl, gr, cfg)),
        "hscan": (swe, cuda_sgm.hscan_plain(c, cfg)),
        "rowsweep": (s, cuda_sgm.rowsweep_plain(c, swe, cfg)),
    }
    errs = {}
    for name, (got, want) in checks.items():
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                                 f"plain {want.dtype}{tuple(want.shape)}")
        errs[name] = max_abs_err(got, want)
        log(f"[2] {name}: {got.dtype} {tuple(got.shape)} max_abs_err {errs[name]}")
        if errs[name] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    del checks

    timed = {
        "cost_volume": (lambda: cuda_sgm.cost_volume(gl, gr, cfg),
                        lambda: cuda_sgm.cost_volume_plain(gl, gr, cfg)),
        "hscan": (lambda: cuda_sgm.hscan(c, cfg),
                  lambda: cuda_sgm.hscan_plain(c, cfg)),
        "rowsweep": (lambda: cuda_sgm.rowsweep(c, swe, cfg),
                     lambda: cuda_sgm.rowsweep_plain(c, swe, cfg)),
    }
    ms, plain_ms = {}, {}
    for name, (kern, plain) in timed.items():
        ms[name] = time_ms(kern)
        plain_ms[name] = time_ms(plain, runs=5)
        log(f"[2] {name}: {ms[name]:.4f} ms, plain {plain_ms[name]:.2f} ms")

    # Least time for the same work: each input read once, each output
    # written once, or the operations at the 32-bit rate, whichever is
    # larger. Operations per (y, x, d): K1 the BT cost once (10) plus a
    # separable running box sum (4); K2 two scan steps (9 each) plus the
    # sum; K3 one scan step plus the sum.
    n = H * W * D
    acc_b = swe.element_size()
    fin_b = s.element_size()
    work = {
        "cost_volume": (2 * H * W * 4 + n * 2, n * 14),
        "hscan": (n * (2 + acc_b), n * 19),
        "rowsweep": (n * (2 + acc_b + fin_b), n * 10),
    }

    # ---- 3. end to end through the user's entry point ----
    est = StereoDepthEstimator(device="cuda")
    est.left_source, est.right_source = left_rgb, right_rgb
    est.configure_sgbm(num_disp=D, focal_length=1000.0, baseline=0.1)
    cuda_sgm.reset_launches()
    for _ in range(3):
        disp, depth = est.estimate_depth()
    launches = dict(cuda_sgm.LAUNCHES)
    log(f"[3] launches over 3 estimate_depth() calls: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")

    if disp.shape != (H, W - D) or depth.shape != disp.shape:
        raise AssertionError(f"output shapes {disp.shape}, {depth.shape}")
    if not np.isfinite(disp).all():
        raise AssertionError("non-finite disparity")
    hit = float((np.abs(disp - SHIFT) <= 1.0).mean())
    log(f"[3] known {SHIFT} px shift recovered on {hit:.4%} of pixels; "
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
    log("[3] raw disparity: kernels == plain versions on the card (exact)")

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
    log("[3] 64x320 pair: card == CPU (disparity exact, depth rtol 1e-5)")

    e2e_full = host_ms(est.estimate_depth)
    ns = StereoDepthEstimator(device="cuda")
    ns.left_source, ns.right_source = left_rgb, right_rgb
    ns.configure_sgbm(num_disp=D, speckle_window_size=0, wls_filter=True,
                      focal_length=1000.0, baseline=0.1)
    ns.core.fast_mode = True
    e2e_ns = host_ms(ns.estimate_depth)
    log(f"[3] ms per 1080p pair: default full postprocess {e2e_full:.2f}, "
        f"north star (no speckle, WLS, fast) {e2e_ns:.2f}")

    # Where a pair's device time goes, stage by stage (CUDA events).
    dcfg, ncfg = est.core.cfg, ns.core.cfg
    raw_m = cuda_sgm.sgm_disparity(pl_, pr_, dcfg)
    raw_ns = pipeline.raw_disparity(pl_, pr_, ncfg)
    stages = {
        "cost_volume_prefilter": lambda: [
            costs.half_sample_envelope(costs.xsobel_prefilter(t, dcfg.prefilter_cap))
            for t in (pl_, pr_)],
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
    split = {name: round(time_ms(fn, runs=5), 3) for name, fn in stages.items()}
    log(f"[3] device ms per stage: {split}")

    # ---- 4. kernels line ----
    source = "depthestimation_torch/csrc/sgm_kernels.cu"
    replaces = {
        "cost_volume": "depthestimation_tpu/ops/pallas_sgm.py:188",
        "hscan": "depthestimation_tpu/ops/pallas_sgm.py:501",
        "rowsweep": "depthestimation_tpu/ops/pallas_sgm.py:595",
    }
    kernels = []
    for name in ("cost_volume", "hscan", "rowsweep"):
        nbytes, nops = work[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "exact": errs[name] == 0,
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
