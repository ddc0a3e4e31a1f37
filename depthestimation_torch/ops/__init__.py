"""Compute ops on PyTorch tensors: cost volume, SGM aggregation, WTA,
filters, color and depth in plain torch, and the CUDA matcher kernels
behind ops/cuda_sgm.py."""

from . import color, costs, cuda_sgm, depth, filters, sgm, wls, wta  # noqa: F401
