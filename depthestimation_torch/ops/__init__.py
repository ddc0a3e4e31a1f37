"""Compute ops on PyTorch tensors: cost volume, SGM aggregation, WTA,
filters, color and depth in plain torch, and the CUDA kernels behind
ops/cuda_sgm.py (the matcher) and ops/remap.py (rectification)."""

from . import color, costs, cuda_sgm, depth, filters, remap, sgm, wls, wta  # noqa: F401
