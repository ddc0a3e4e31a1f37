"""Bilinear remap (cv2.remap INTER_LINEAR, BORDER_CONSTANT 0) through the
rectification maps, on a hand-written CUDA kernel with a plain version.

Counterpart of depthestimation_tpu/ops/remap.py. The TPU's banded
shifted-plane sum exists only to avoid gathers there; the kernel here
(csrc/remap_kernels.cu) is a direct 4-tap gather and covers every map, so
there is one route and no fallback. Both versions take the banded
kernel's association, ((w00*v00 + w01*v01) + w10*v10) + w11*v11 with
w00 = (1-fy)*(1-fx) (remap.py:95-100 there), and agree bit for bit.

The wrapper takes a tensor on the CPU through the plain version and
launches the kernel for a tensor on the card; it never falls back. Each
launch adds one to LAUNCHES["remap"] and each call on the card one to
CALLS["remap"] (cuda_build).
"""

from __future__ import annotations

import torch

from .cuda_build import (called as _called, check as _check,
                         launched as _launched, load_library,
                         on_card as _on_card, stream as _stream)

__all__ = ["remap_bilinear", "remap_bilinear_plain"]


def remap_bilinear_plain(img: torch.Tensor, map_x: torch.Tensor,
                         map_y: torch.Tensor) -> torch.Tensor:
    """Plain version: sample each (H, W) image of img (H, W) or (N, H, W)
    at the float32 coordinates (map_x, map_y) of the same shape, bilinear;
    a tap outside the image reads 0."""
    h, w = img.shape[-2:]
    flat = img.to(torch.float32).reshape(-1, h * w)
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    gx = 1.0 - fx
    gy = 1.0 - fy

    def tap(yf, xf):
        inb = (yf >= 0) & (yf <= h - 1) & (xf >= 0) & (xf <= w - 1)
        idx = (yf.clamp(0, h - 1).to(torch.int64) * w
               + xf.clamp(0, w - 1).to(torch.int64))
        v = torch.gather(flat, 1, idx.reshape(flat.shape[0], -1))
        return torch.where(inb, v.reshape(idx.shape), 0.0)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    out = (gy * gx) * v00 + (gy * fx) * v01
    out = out + (fy * gx) * v10
    return out + (fy * fx) * v11


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of img, (H, W) or (N, H, W) float32, through maps of
    the same shape -> float32 of that shape. One launch for all N images
    (the pipeline rectifies both images of a pair at once)."""
    if not _on_card(img):
        return remap_bilinear_plain(img, map_x, map_y)
    if img.ndim not in (2, 3):
        raise ValueError(f"img must be (H, W) or (N, H, W), not {tuple(img.shape)}")
    _check(img, "img", torch.float32, img.shape, img.device)
    _check(map_x, "map_x", torch.float32, img.shape, img.device)
    _check(map_y, "map_y", torch.float32, img.shape, img.device)
    h, w = img.shape[-2:]
    n = img.shape[0] if img.ndim == 3 else 1
    out = torch.empty_like(img)
    _launched("remap", load_library().remap_bilinear(
        img.data_ptr(), map_x.data_ptr(), map_y.data_ptr(), out.data_ptr(),
        n, h, w, _stream(),
    ))
    _called("remap")
    return out
