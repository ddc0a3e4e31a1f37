"""Edge-preserving (WLS-style) disparity refinement + temporal smoothing
(plain PyTorch; counterpart of depthestimation_tpu/ops/wls.py).

- wls_refine: a confidence-weighted guided filter on the disparity map,
  guided by the left image -- the closed-form O(1)-per-pixel stand-in for
  the weighted-least-squares smoothing of cv2.ximgproc's
  DisparityWLSFilter. Invalid pixels get zero confidence and are filled
  from their edge-consistent neighbourhood.
- temporal_smooth: per-pixel exponential smoothing with change rejection
  for streaming input.
"""

from __future__ import annotations

import torch

from .filters import box_mean

__all__ = ["wls_refine", "temporal_smooth"]


def wls_refine(
    disparity: torch.Tensor,
    guide: torch.Tensor,
    radius: int = 8,
    eps: float = 100.0,
    invalid_below: float = 0.0,
) -> torch.Tensor:
    """Confidence-weighted guided filter of `disparity` steered by `guide`.

    q = mean(a) * I + mean(b), a = cov_w(I, p) / (var(I) + eps),
    with all p-statistics confidence-weighted.
    """
    p = disparity.to(torch.float32)
    i = guide.to(torch.float32)
    k = 2 * radius + 1
    w = (p > invalid_below).to(torch.float32)

    mean_i = box_mean(i, k)
    corr_ii = box_mean(i * i, k)
    var_i = torch.clamp(corr_ii - mean_i * mean_i, min=0.0)

    wsum = torch.clamp(box_mean(w, k), min=1e-4)
    mean_p = box_mean(w * p, k) / wsum
    mean_ip = box_mean(w * i * p, k) / wsum
    mean_i_w = box_mean(w * i, k) / wsum
    cov_ip = mean_ip - mean_i_w * mean_p

    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i_w

    return box_mean(a, k) * i + box_mean(b, k)


def temporal_smooth(
    disp_new: torch.Tensor,
    disp_prev: torch.Tensor | None,
    alpha: float = 0.4,
    max_change: float = 4.0,
    invalid_below: float = 0.0,
) -> torch.Tensor:
    """out = alpha * new + (1 - alpha) * prev where both frames are valid
    and the change is at most max_change; otherwise the new frame. Pass
    disp_prev=None on the first frame."""
    new = disp_new.to(torch.float32)
    if disp_prev is None:
        return new
    prev = disp_prev.to(torch.float32)
    ok = (new > invalid_below) & (prev > invalid_below) & (
        torch.abs(new - prev) <= max_change
    )
    return torch.where(ok, alpha * new + (1.0 - alpha) * prev, new)
