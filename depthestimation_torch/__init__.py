"""depthestimation_torch -- the stereo depth engine on PyTorch and CUDA.

The port of depthestimation_tpu (JAX/XLA/Pallas on a TPU) to PyTorch on
an NVIDIA H100: plain tensor code is PyTorch, and the TPU's Pallas
kernels are CUDA C++ kernels written for Hopper (csrc/). The JAX package
stays the reference; this package imports nothing of it nor of JAX.

This slice covers the default stereo path (grayscale, sgbm_3way matcher
with the BT cost, post-filters, depth) behind StereoDepthEstimator.
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
