"""Single stereo pair -> disparity + depth on the card.

Workload: the Middlebury-style pair the reference demos use (2964x1988,
ndisp 280, processed at 0.5 downscale). Calibration can come from a
Middlebury calib.txt (parsed, not hand-copied) or from the CLI flags.

    python -m depthestimation_torch.examples.stereo [LEFT.png RIGHT.png]
        [--calib calib.txt] [--device cuda|cpu] [--no-viz]

Without the default asset files it synthesizes the demo scene (exact
ground-truth disparity) under ./assets and uses its calibration.
"""

from __future__ import annotations

import argparse
import os
import time

from ..api import StereoDepthEstimator
from ..config import parse_calib_file

DEFAULT_PAIR = ("./assets/stereo_pairs/im0.png", "./assets/stereo_pairs/im1.png")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("left", nargs="?", default=DEFAULT_PAIR[0])
    p.add_argument("right", nargs="?", default=DEFAULT_PAIR[1])
    p.add_argument("--calib", help="Middlebury calib.txt to parse")
    p.add_argument("--downscale", type=float, default=0.5)
    p.add_argument("--ndisp", type=int, default=280)
    p.add_argument("--focal", type=float, default=3997.684)
    p.add_argument("--baseline-mm", type=float, default=193.001)
    p.add_argument("--doffs", type=float, default=131.111)
    p.add_argument("--mode", default="sgbm_3way",
                   choices=["sgbm", "hh", "sgbm_3way", "hh4"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--no-viz", action="store_true",
                   help="skip the matplotlib windows")
    return p.parse_args(argv)


def ensure_inputs(args):
    """When the default asset paths are missing, synthesize the demo scene
    and use its calibration, so the example runs on a fresh checkout with
    no external files; with the default paths, ./assets/calib.txt is used
    when no --calib is given."""
    if (args.left, args.right) != DEFAULT_PAIR:
        return args
    if not (os.path.exists(args.left) and os.path.exists(args.right)):
        from ..io.synthetic import write_demo_assets

        paths = write_demo_assets("./assets")
        print(f"[example] synthesized demo stereo pair under ./assets "
              f"({paths['left']})")
    if args.calib is None and os.path.exists("./assets/calib.txt"):
        args.calib = "./assets/calib.txt"
    return args


def run(argv=None) -> StereoDepthEstimator:
    """Everything main does: load, configure, estimate, print the latency
    and disparity lines, and show the results unless --no-viz. Returns
    the estimator, which holds disparity_map and depth_map."""
    args = ensure_inputs(parse_args(argv))
    est = StereoDepthEstimator(
        left_source=args.left, right_source=args.right,
        downscale_factor=args.downscale, device=args.device,
    )
    if args.calib:
        est.configure_sgbm(**parse_calib_file(args.calib)["sgbm_kwargs"],
                           sgbm_mode=args.mode)
    else:
        est.configure_sgbm(
            num_disp=args.ndisp,
            focal_length=args.focal,
            baseline=args.baseline_mm / 1000.0,
            doffs=args.doffs,
            sgbm_mode=args.mode,
        )

    t0 = time.perf_counter()
    disparity_px, depth_m = est.estimate_depth()
    print(f"pipeline latency: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"on {est.core.device} (a first call on the card includes building "
          "the kernels)")

    ok = disparity_px > 0
    if ok.any():
        print(f"disparity: shape {disparity_px.shape}, "
              f"valid {100 * ok.mean():.1f}%, "
              f"range [{disparity_px[ok].min():.2f}, {disparity_px[ok].max():.2f}] px")
    else:
        print(f"disparity: shape {disparity_px.shape}, no valid pixel")
    if not args.no_viz:
        est.visualize_results()
    return est


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
