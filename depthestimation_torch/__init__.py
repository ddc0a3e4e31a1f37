"""depthestimation_torch -- the stereo and monocular depth engine on
PyTorch and CUDA.

The port of depthestimation_tpu (JAX/XLA/Pallas on a TPU) to PyTorch on
an NVIDIA H100: plain tensor code is PyTorch, and the TPU's Pallas
kernels are CUDA C++ kernels written for Hopper (csrc/). The JAX package
stays the reference; this package imports nothing of it nor of JAX.

It covers the stereo paths behind StereoDepthEstimator (one pair) and
StereoDepthEstimatorVideo (a stream of pairs, staged into the card on a
copy stream by an input thread, read back asynchronously, with per-frame
metrics): grayscale, full-calibration rectification, the SGM matcher in
all four modes (sgbm_3way, hh4, sgbm, hh) with the BT or census cost,
post-filters and depth; plus synthetic scenes, profiling hooks and
visualization. MonocularDepthEstimator runs the ViT+DPT monocular net
(Depth Anything V2's architecture; weights from a size preset's seeded
init, the port's checkpoint or an HF snapshot) in plain PyTorch, with
PIL's bicubic preprocessing written out in torch.
"""

from .api import (  # noqa: F401
    MonocularDepthEstimator,
    StereoDepthEstimator,
    StereoDepthEstimatorVideo,
)
from .config import CalibConfig, SGMConfig, config_from_dict, parse_calib_file  # noqa: F401
from .io.synthetic import synthesize_stereo_pair  # noqa: F401
from .io.threaded import StereoInputPipeline  # noqa: F401
from .pipeline import StereoPipeline  # noqa: F401
from .viz import (  # noqa: F401
    visualize_depth,
    visualize_disparity,
    visualize_disparity_and_depth,
    visualize_stereo_pair,
)

__all__ = [
    "StereoDepthEstimator",
    "StereoDepthEstimatorVideo",
    "MonocularDepthEstimator",
    "StereoInputPipeline",
    "StereoPipeline",
    "SGMConfig",
    "CalibConfig",
    "config_from_dict",
    "parse_calib_file",
    "synthesize_stereo_pair",
    "visualize_stereo_pair",
    "visualize_disparity",
    "visualize_depth",
    "visualize_disparity_and_depth",
]
