"""Disparity -> depth conversion (plain PyTorch; counterpart of
depthestimation_tpu/ops/depth.py).

Reference semantics: stereo_core.py:234-272 -- Z = f*B/(d + doffs), invalid
(adjusted disparity <= eps) mapped to +inf, optional max_depth clamp. The
reference quirk of passing eps = min_disp is kept by the pipeline caller.
"""

from __future__ import annotations

import torch

__all__ = ["disparity_to_depth"]


def disparity_to_depth(disp, f_pixels, baseline_m, doffs=0.0, eps=1e-6, max_depth=None):
    """Convert disparity (pixels) to depth (meters), float32."""
    disp = disp.to(torch.float32)
    adjusted = disp + doffs
    valid = adjusted > eps
    # f*B is rounded to float32 once and divided in float32, as in JAX
    # (a Python scalar over a tensor would go through a reciprocal); a
    # fill on the device, not a copy from the host, which would wait.
    fb = torch.full((), f_pixels * baseline_m, dtype=torch.float32, device=disp.device)
    z = torch.where(valid, fb / torch.where(valid, adjusted, 1.0), float("inf"))
    if max_depth is not None:
        z = torch.clamp(z, max=max_depth)
    return z
