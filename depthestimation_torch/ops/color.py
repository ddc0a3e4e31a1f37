"""Color conversion (plain PyTorch; counterpart of depthestimation_tpu/ops/color.py).

Reference analogue: cv2.cvtColor BT.601 grayscale (rectify.py:108-119,
stereo_core.py:155-160, input.py:35-36). The resizers come with the
rectification slice.
"""

from __future__ import annotations

import torch

__all__ = ["to_grayscale"]

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
