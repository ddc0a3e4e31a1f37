"""Device time of each stage of the hh4 matcher and of the postprocess,
on the card, at 1080x1920 with 128 disparities.

Each stage is timed by CUDA events around one call enqueued behind a
sleep kernel three times longer than the call takes the host to enqueue
(plus 2 ms), so the events bracket the card's time and not the host's;
median of 7 after a warm-up. A stage that makes more launches than the
stream's queue holds makes the host wait for the card, and its events
then include that wait; its host column shows the enqueue time.

Stages: K1 cost volume; K2's two launches apart (forward L->R; backward
R->L fused with the sum), each through cuda_sgm.hscan_launch;
K3's downward and upward passes (hh4's two); the WTA stage (one kernel
on the card) with and without the LR check, and the plain LR check alone
(lr_invalidate, which the disparity-sharded matcher runs); the whole
matcher; then the postprocess stages on a seeded disparity map with 15 %
holes.

    python -m depthestimation_torch.tools.profile_kernels

It needs a card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..config import SGMConfig
from ..ops import cuda_sgm, filters, wta
from ..pipeline import _resolve_device

Row = Tuple[str, float, float]  # (stage, device ms, host enqueue ms)


def sleep_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per ms on this card, from 10 M cycles."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_stage(fn: Callable[[], object], cycles_per_ms: float, runs: int = 7
               ) -> Tuple[float, float]:
    """(median device ms, median host enqueue ms) of fn() on the card."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    sleep = int((3 * max(host) + 2.0) * cycles_per_ms)
    dev = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    return float(np.median(dev)), float(np.median(host))


def profile(verbose: bool = True) -> List[Row]:
    """The stage rows of the hh4 matcher at 1080x1920x128 on a seeded
    integer pair whose right image is the left moved by 16 px, then the
    postprocess stages at 1080x1792."""
    h, w, d = 1080, 1920, 128
    dev = _resolve_device("cuda")
    cfg = SGMConfig(num_disp=d, sgbm_mode="hh4", speckle_window_size=0)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (h, w + 32)).astype(np.float32)
    left = torch.tensor(base[:, :w], device=dev)
    right = torch.tensor(base[:, 16:w + 16], device=dev)
    cycles = sleep_cycles_per_ms()
    rows: List[Row] = []

    def stage(name, fn):
        ms, host = time_stage(fn, cycles)
        rows.append((name, ms, host))
        if verbose:
            print(f"{name:30s} {ms:9.3f} ms   (host enqueue {host:.3f} ms)", flush=True)

    acc, final = cuda_sgm._acc_dtype(cfg), cuda_sgm._final_dtype(cfg)
    c = cuda_sgm.cost_volume(left, right, cfg)
    l_lr = torch.empty_like(c)
    swe = torch.empty((h, w, d), dtype=acc, device=dev)
    s_down = cuda_sgm.rowsweep(c, cuda_sgm.hscan(c, cfg), cfg, (0,), False, acc)
    s = cuda_sgm.rowsweep(c, s_down, cfg, (0,), True, final)
    stage("K1 cost_volume", lambda: cuda_sgm.cost_volume(left, right, cfg))
    stage("K2 forward (L->R)", lambda: cuda_sgm.hscan_launch(c, None, l_lr, cfg))
    stage("K2 backward + sum (R->L)", lambda: cuda_sgm.hscan_launch(c, l_lr, swe, cfg))
    stage("K3 rowsweep down", lambda: cuda_sgm.rowsweep(c, swe, cfg, (0,), False, acc))
    stage("K3 rowsweep up (S out)", lambda: cuda_sgm.rowsweep(c, s_down, cfg, (0,), True,
                                                              final))
    stage("WTA tail (with LR)", lambda: wta.wta_disparity(
        s, cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff))
    si = s.to(torch.int32)
    packed = (si * 256 + torch.arange(d, dtype=torch.int32, device=dev)).amin(dim=-1)
    mins, d0 = packed >> 8, packed & 255
    valid = torch.ones_like(d0, dtype=torch.bool)
    stage("LR check (lr_invalidate)", lambda: wta.lr_invalidate(
        d0, mins, valid, cfg.disp12_max_diff, cfg.min_disp, d))
    stage("WTA tail minus LR", lambda: wta.wta_disparity(
        s, cfg.min_disp, cfg.uniqueness_ratio, -1))
    stage("full matcher", lambda: cuda_sgm.sgm_disparity(left, right, cfg))
    matcher = sum(ms for name, ms, _ in rows[:6])
    rows.append(("sum of K1-K3 and the WTA tail", matcher, float("nan")))
    if verbose:
        print(f"{'sum of K1-K3 and the WTA tail':30s} {matcher:9.3f} ms", flush=True)
    del c, l_lr, swe, s_down, s, si

    rng = np.random.default_rng(1)
    dmap = (rng.integers(0, d * 16, (h, w - d)) / 16.0).astype(np.float32)
    dmap[rng.random((h, w - d)) < 0.15] = 0.0
    x = torch.tensor(dmap, device=dev)
    stage("speckle S=50 (in matcher)", lambda: filters.filter_speckles(x, -1.0, 50, 1.0))
    stage("speckle S=100 (postprocess)", lambda: filters.filter_speckles(x, 0.0, 100, 1.0))
    stage("detect_outliers k=5", lambda: filters.detect_outliers(x, 2.5, 5))
    stage("fill_holes inpaint", lambda: filters.fill_holes(x, method="inpaint",
                                                           kernel_size=3))
    stage("median3x3", lambda: filters.median3x3(x))
    stage("postprocess_disparity", lambda: filters.postprocess_disparity(
        x, max_speckle_size=100, max_diff=1.0, outlier_threshold=2.5,
        fill_method="inpaint", apply_outlier_removal=True, apply_hole_filling=True))
    return rows


def table(rows: List[Row]) -> str:
    lines = ["| stage | device ms | host enqueue ms |", "|---|---|---|"]
    lines += [f"| {name} | {ms:.3f} | {host:.3f} |" for name, ms, host in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    rows = profile()
    print(f"\n{torch.cuda.get_device_name(0)}")
    print(table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
