"""Streaming stereo depth: capture -> SGM on the card -> live view + metrics.

Workload: the reference's video demo geometry (128 disparities at 0.7
downscale). Sources can be files, camera indices, RTSP URLs, or any
iterable of frames; the input thread stages each pair into the card's
memory and the facade enqueues frame N+1 before it reads frame N back.

    python -m depthestimation_torch.examples.stereo_live [LEFT_SRC RIGHT_SRC]
        [--fps 0] [--frames N] [--device cuda|cpu] [--no-viz]

Without the default video files it streams the synthetic moving scene.
"""

from __future__ import annotations

import argparse
import os

from ..api import StereoDepthEstimatorVideo

DEFAULT_VIDEOS = ("./assets/left.mp4", "./assets/right.mp4")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("left", nargs="?", default=DEFAULT_VIDEOS[0])
    p.add_argument("right", nargs="?", default=DEFAULT_VIDEOS[1])
    p.add_argument("--fps", type=int, default=30, help="throttle ceiling (0: none)")
    p.add_argument("--downscale", type=float, default=0.7)
    p.add_argument("--frames", type=int, default=60,
                   help="synthetic-stream length when no videos are given")
    p.add_argument("--drop-frames", action="store_true",
                   help="live-camera policy: evict stale frames")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--no-viz", action="store_true",
                   help="no live window (it needs matplotlib)")
    return p.parse_args(argv)


def run(argv=None, on_frame=None) -> StereoDepthEstimatorVideo:
    """Everything main does: pick the sources, configure the facade and
    stream, printing the metrics every 30 frames and at the end.
    on_frame(i, depth_m), when given, sees every yielded depth map.
    Returns the facade (its metrics hold the stream's numbers)."""
    args = parse_args(argv)
    left_src, right_src = args.left, args.right
    num_disp, focal, baseline_mm = 128, 679.01, 572.5
    if left_src == DEFAULT_VIDEOS[0] and not os.path.exists(left_src):
        # No videos: stream the synthetic moving scene so the demo runs on
        # a fresh checkout with no external files.
        from ..io.synthetic import DEMO_CALIB, synthetic_stream

        print("[example] no video files found; streaming a synthetic scene")
        left_src, right_src = synthetic_stream(n_frames=args.frames)
        num_disp = DEMO_CALIB["ndisp"]
        focal = DEMO_CALIB["focal_px"]
        baseline_mm = DEMO_CALIB["baseline_mm"]

    est = StereoDepthEstimatorVideo(
        left_source=left_src,
        right_source=right_src,
        downscale_factor=args.downscale,
        visualize_live=not args.no_viz,
        target_fps=args.fps,
        drop_frames=args.drop_frames,
        device=args.device,
    )
    est.configure_sgbm(
        num_disp=num_disp,
        focal_length=focal,
        baseline=baseline_mm / 1000.0,
        doffs=0,
        hole_filling=True,
        temporal_alpha=0.4,  # flow-free temporal smoothing for streams
    )

    for i, depth_m in enumerate(est.estimate_depth()):
        if on_frame is not None:
            on_frame(i, depth_m)
        if i % 30 == 0:
            print(f"frame {i}: {est.metrics.summary()}")
    print(f"stream done: {est.metrics.summary()}")
    return est


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
