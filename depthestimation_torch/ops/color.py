"""Color conversion (plain PyTorch; counterpart of depthestimation_tpu/ops/color.py).

Reference analogues: cv2.cvtColor BT.601 grayscale (rectify.py:108-119,
stereo_core.py:155-160, input.py:35-36), cv2.resize INTER_LINEAR
(rectify.py:105) and INTER_AREA (input.py:39-43), which the JAX package
computes with jax.image.resize. The resizes here are jax.image.resize's
weight matrices (compute_weight_mat), one matmul per axis; the mono net's
position-embedding and fusion resizes use them too.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["to_grayscale", "compute_weight_mat", "resize", "resize_bilinear",
           "resize_area", "downscale"]

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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, on x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def compute_weight_mat(n_in: int, n_out: int, method: str = "linear",
                       antialias: bool = True, device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of jax.image.resize along one axis
    (jax/_src/image/scale.py, compute_weight_mat): half-pixel centres, the
    triangle ('linear') or Keys cubic ('cubic', a = -0.5) kernel, widened
    by the scale when downsizing with antialias, columns renormalised to
    sum to 1 at the borders. F.interpolate's bicubic uses a = -0.75 and
    never widens, so it is not this resize."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
    # A tensor divisor, so the card divides as the CPU does (CUDA
    # multiplies by the reciprocal of a host scalar).
    scale = torch.full((), kernel_scale, device=device)
    weights = kernel(torch.abs(sample[None, :] - src) / scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


@functools.lru_cache(maxsize=None)
def _weight_mat(n_in: int, n_out: int, method: str, antialias: bool,
                device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """compute_weight_mat in `dtype`, built once per device. Built outside
    inference mode, so that later autograd use of the cached tensor is
    allowed. Never evicted: a captured CUDA graph (graphs.py) reads the
    tensor's memory on every replay."""
    with torch.inference_mode(False):
        return compute_weight_mat(n_in, n_out, method, antialias, device).to(dtype)


def resize(x: torch.Tensor, sizes: dict, method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """jax.image.resize of float x along the dims named in `sizes`
    ({dim: new size}); a dim whose size does not change is left as it is,
    as jax.image.resize leaves it."""
    for dim, n_out in sizes.items():
        n_in = x.shape[dim]
        if n_out == n_in:
            continue
        w = _weight_mat(n_in, n_out, method, antialias, x.device, x.dtype)
        x = torch.movedim(torch.movedim(x, dim, -1) @ w, -1, dim)
    return x


def resize_bilinear(img: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Bilinear resize of an (H, W) image to out_hw, float32 out
    (jax.image.resize(method='linear', antialias=False), which is what
    the JAX package's color.resize_bilinear calls; F.interpolate's
    bilinear mode places and clamps samples differently). An axis whose
    size does not change is left as it is."""
    return resize(img.to(torch.float32), {0: out_hw[0], 1: out_hw[1]}, "linear",
                  antialias=False)


def resize_area(img: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Area-average resize for downscaling (cv2.INTER_AREA's role), as the
    JAX package computes it: jax.image.resize 'linear' with antialias on
    (H, W) or (H, W, C). Integer input comes back rounded and clipped to
    0..255 in its dtype; float input gives float32."""
    out = resize(img.to(torch.float32), {0: out_hw[0], 1: out_hw[1]}, "linear")
    if img.dtype.is_floating_point:
        return out
    return torch.clamp(torch.round(out), 0, 255).to(img.dtype)


def downscale(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Downscale by a factor in (0, 1] with input.py's size math (int
    truncation of h*f, w*f)."""
    if factor == 1.0:
        return img
    h, w = img.shape[:2]
    return resize_area(img, (int(h * factor), int(w * factor)))
