"""Color conversion (plain PyTorch; counterpart of depthestimation_tpu/ops/color.py).

Reference analogues: cv2.cvtColor BT.601 grayscale (rectify.py:108-119,
stereo_core.py:155-160, input.py:35-36) and cv2.resize INTER_LINEAR
(rectify.py:105), which the JAX package computes with jax.image.resize.
"""

from __future__ import annotations

import torch

__all__ = ["to_grayscale", "resize_bilinear"]

# ITU-R BT.601 luma weights, RGB order (cv2 uses the same weights; its
# BGR2GRAY just reverses the coefficient order).
_BT601 = (0.299, 0.587, 0.114)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """Convert (H, W, 3) RGB (or pass through (H, W)) to grayscale.

    Matches cv2.cvtColor(RGB2GRAY) BT.601 semantics (rectify.py:116-118).
    Integer input stays on the 0..255 scale, rounded like cv2, and keeps
    its dtype; float input gives float32.
    """
    if img.ndim == 2:
        return img
    if img.ndim == 3 and img.shape[2] == 1:
        return img[:, :, 0]
    if img.ndim == 3 and img.shape[2] == 3:
        f = img.to(torch.float32)
        gray = (f[..., 0] * _BT601[0] + f[..., 1] * _BT601[1]) + f[..., 2] * _BT601[2]
        if img.dtype.is_floating_point:
            return gray
        return torch.round(gray).to(img.dtype)
    raise ValueError("Unsupported image format for grayscale conversion")


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's 'linear' method without
    antialiasing along one axis (jax/_src/image/scale.py,
    compute_weight_mat): half-pixel centres, a triangle kernel, columns
    renormalised to sum to 1 at the borders."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
    weights = torch.clamp(1.0 - torch.abs(sample[None, :] - src), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(img: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Bilinear resize of an (H, W) image to out_hw, float32 out
    (jax.image.resize(method='linear', antialias=False), which is what
    the JAX package's color.resize_bilinear calls; F.interpolate's
    bilinear mode places and clamps samples differently). An axis whose
    size does not change is left as it is."""
    out = img.to(torch.float32)
    h, w = out.shape
    if out_hw[0] != h:
        out = _linear_weights(h, out_hw[0], out.device).T @ out
    if out_hw[1] != w:
        out = out @ _linear_weights(w, out_hw[1], out.device)
    return out
