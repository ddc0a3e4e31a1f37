"""depthestimation_torch -- the stereo depth engine on PyTorch and CUDA.

The port of depthestimation_tpu (JAX/XLA/Pallas on a TPU) to PyTorch on
an NVIDIA H100: plain tensor code is PyTorch, and the TPU's Pallas
kernels are CUDA C++ kernels written for Hopper (csrc/). The JAX package
stays the reference; this package imports nothing of it nor of JAX.

It covers the single-pair stereo path behind StereoDepthEstimator:
grayscale, full-calibration rectification, the SGM matcher in all four
modes (sgbm_3way, hh4, sgbm, hh) with the BT or census cost, post-filters
and depth.
"""

from .api import StereoDepthEstimator  # noqa: F401
from .config import CalibConfig, SGMConfig, config_from_dict, parse_calib_file  # noqa: F401
from .pipeline import StereoPipeline  # noqa: F401

__all__ = [
    "StereoDepthEstimator",
    "StereoPipeline",
    "SGMConfig",
    "CalibConfig",
    "config_from_dict",
    "parse_calib_file",
]
