"""User-facing estimator facade (counterpart of depthestimation_tpu/api.py).

API-capability parity with the reference's StereoDepthEstimator
(depthlib/StereoDepthEstimator.py). The video and monocular facades come
with later slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .io.input import load_stereo_pair
from .pipeline import StereoPipeline

__all__ = ["StereoDepthEstimator"]


class StereoDepthEstimator:
    """Single stereo pair -> (disparity, depth).

    Parity: depthlib/StereoDepthEstimator.py:10-123 -- validates
    downscale_factor in (0, 1], loads + downscales the pair at init,
    delegates to the pipeline core, keeps disparity_map/depth_map.
    device defaults to "cuda" and raises RuntimeError when no card is
    usable; pass device="cpu" for the plain versions.
    """

    def __init__(self, left_source=None, right_source=None, downscale_factor=1.0,
                 device="cuda"):
        if downscale_factor <= 0 or downscale_factor > 1.0:
            raise ValueError("downscale_factor must be between 0 and 1.")
        self.downscale_factor = downscale_factor
        self.core = StereoPipeline(downscale_factor=downscale_factor, device=device)

        self.left_source = None
        self.right_source = None
        if left_source is not None and right_source is not None:
            self.left_source, self.right_source = load_stereo_pair(
                left_source, right_source, downscale_factor=downscale_factor
            )
        self.disparity_map = None
        self.depth_map = None

    def configure_sgbm(self, **kwargs):
        """Configure matcher parameters (configure_sgbm parity; scaling
        semantics in SGMConfig.updated)."""
        self.core.configure(**kwargs)

    def get_sgbm_params(self) -> Dict:
        return self.core.get_params()

    def estimate_depth(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.left_source is None or self.right_source is None:
            raise ValueError(
                "Left and right sources must be provided for depth estimation."
            )
        disparity_px, depth_m = self.core.estimate_depth(
            self.left_source, self.right_source
        )
        self.disparity_map = disparity_px
        self.depth_map = depth_m
        return disparity_px, depth_m

    def visualize_results(self):
        raise NotImplementedError(
            "visualization is not ported yet; it comes with the streaming "
            "slice (viz.py)"
        )
