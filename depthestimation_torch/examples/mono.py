"""Monocular depth with the ViT+DPT net on the card.

Mirrors the reference demo (example_mono.py): the demo scene's left
image at 0.5 downscale through MODEL_PATH, which may be a checkpoint
directory (MonoDepthModel.save, or the JAX package's), an HF
Depth-Anything-V2 snapshot (weights converted on load), or a size preset
('small'/'base'/'large') for a seeded random init.

    python -m depthestimation_torch.examples.mono [--device cuda|cpu] [--no-viz]

Without ./assets/stereo_pairs/im0.png it synthesizes the demo scene.
"""

from __future__ import annotations

import argparse
import os
import time

from ..api import MonocularDepthEstimator

IMAGE_PATH = "./assets/stereo_pairs/im0.png"
MODEL_PATH = "small"  # or a checkpoint / HF snapshot directory


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--no-viz", action="store_true",
                   help="skip the matplotlib window")
    return p.parse_args(argv)


def run(argv=None) -> MonocularDepthEstimator:
    """Everything main does: load the model, estimate one image's depth,
    print the latency, and show it unless --no-viz. Returns the
    estimator, which holds depth_map."""
    args = parse_args(argv)
    image_path = IMAGE_PATH
    if not os.path.exists(image_path):
        from ..io.synthetic import write_demo_assets

        image_path = write_demo_assets("./assets")["left"]

    estimator = MonocularDepthEstimator(
        model_path=MODEL_PATH, device=args.device, downscale_factor=0.5
    )
    start_time = time.time()
    estimator.estimate_depth(image_path=image_path)
    latency_ms = (time.time() - start_time) * 1000
    print(f"Depth estimation completed in {latency_ms:.2f} ms")
    if not args.no_viz:
        estimator.visualize_depth()
    return estimator


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
