"""Matching-cost volume construction (plain PyTorch).

Counterpart of depthestimation_tpu/ops/costs.py (OpenCV's calcPixelCostBT
+ SAD window, reference stereo_core.py:63-75,231):

- x-Sobel prefilter clipped to +-prefilter_cap;
- Birchfield-Tomasi sampling-insensitive pixel cost with half-pixel
  min/max envelopes on both images;
- block_size x block_size SAD window with edge-replicated borders;
- or the census cost: Hamming distance of packed radius-2 census words,
  summed over the same window.

This is the plain version of the cost kernel (ops/cuda_sgm.cost_volume).

Layout: the cost volume is (H, W, D) with D innermost.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["xsobel_prefilter", "half_sample_envelope", "bt_cost_volume",
           "census_transform", "census_cost_volume", "cost_volume"]


def _pad_edge(img: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Edge-replicate a 2-D tensor (F.pad's replicate mode wants a
    channel axis)."""
    return F.pad(img[None], (left, right, top, bottom), mode="replicate")[0]


def xsobel_prefilter(img: torch.Tensor, cap: int) -> torch.Tensor:
    """Clipped horizontal Sobel derivative, mapped to [0, 2*cap].

    OpenCV SGBM prefilters with value = clip(sobel_x, -cap, cap) + cap
    before the BT cost; `cap` is prefilter_cap (stereo_core.py:70).
    """
    p = _pad_edge(img.to(torch.float32), 1, 1, 1, 1)
    # Sobel-x: [[-1,0,1],[-2,0,2],[-1,0,1]] correlation.
    dx = (
        (p[:-2, 2:] - p[:-2, :-2])
        + 2.0 * (p[1:-1, 2:] - p[1:-1, :-2])
        + (p[2:, 2:] - p[2:, :-2])
    )
    return torch.clamp(dx, -cap, cap) + cap


def half_sample_envelope(img: torch.Tensor):
    """Per-pixel min/max over {v, (v+v_left)/2, (v+v_right)/2} (BT).

    Half samples use integer truncation like OpenCV's (a+b)/2 on
    non-negative prefiltered values, keeping costs on an integer grid."""
    left = _pad_edge(img, 0, 0, 1, 0)[:, :-1]
    right = _pad_edge(img, 0, 0, 0, 1)[:, 1:]
    hl = torch.floor(0.5 * (img + left))
    hr = torch.floor(0.5 * (img + right))
    vmin = torch.minimum(img, torch.minimum(hl, hr))
    vmax = torch.maximum(img, torch.maximum(hl, hr))
    return vmin, vmax


def _shift_right_stack(arr: torch.Tensor, min_disp: int, num_disp: int) -> torch.Tensor:
    """Gather arr[h, x - (min_disp + d)] for d in [0, num_disp).

    Out-of-image indices are clamped to column 0 (edge replication), the
    border convention OpenCV uses for the invalid left band, which the
    pipeline later crops (stereo_core.py:168). Returns (H, W, D).
    """
    w = arr.shape[1]
    x = torch.arange(w, device=arr.device)[:, None]
    d = torch.arange(num_disp, device=arr.device)[None, :] + min_disp
    idx = torch.clamp(x - d, 0, w - 1)  # (W, D)
    return arr[:, idx]


def _block_sum(vol: torch.Tensor, block_size: int) -> torch.Tensor:
    """SAD window: box-sum each (H, W) slice of (H, W, D) over a
    block_size^2 window with edge-replicated padding (OpenCV clamps window
    taps at the border)."""
    if block_size <= 1:
        return vol
    r = block_size // 2
    h, w, _ = vol.shape
    ys = torch.clamp(torch.arange(-r, h + r, device=vol.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-r, w + r, device=vol.device), 0, w - 1)
    padded = vol[ys]
    rows = padded[0:h]
    for k in range(1, block_size):
        rows = rows + padded[k:k + h]
    rows = rows[:, xs]
    out = rows[:, 0:w]
    for k in range(1, block_size):
        out = out + rows[:, k:k + w]
    return out


def bt_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disp: int,
    min_disp: int = 0,
    block_size: int = 5,
    prefilter_cap: int = 31,
) -> torch.Tensor:
    """Birchfield-Tomasi cost volume on Sobel-prefiltered images.

    Returns (H, W, D) float32; C[h, x, d] is the block-aggregated matching
    cost between left pixel x and right pixel x - (min_disp + d). Exact on
    integer-valued images: every partial sum is a small integer in float32.
    """
    pl_ = xsobel_prefilter(left, prefilter_cap)
    pr = xsobel_prefilter(right, prefilter_cap)

    umin, umax = half_sample_envelope(pl_)
    vmin, vmax = half_sample_envelope(pr)

    v = _shift_right_stack(pr, min_disp, num_disp)
    v0 = _shift_right_stack(vmin, min_disp, num_disp)
    v1 = _shift_right_stack(vmax, min_disp, num_disp)

    u = pl_[:, :, None]
    u0 = umin[:, :, None]
    u1 = umax[:, :, None]

    zero = torch.zeros((), dtype=torch.float32, device=left.device)
    c0 = torch.maximum(torch.maximum(u - v1, v0 - u), zero)
    c1 = torch.maximum(torch.maximum(v - u1, u0 - v), zero)
    pixel_cost = torch.minimum(c0, c1)

    return _block_sum(pixel_cost, block_size)


def census_transform(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Census transform over a (2r+1)^2 window with edge padding, packed
    into int32 words: bit k is set where the k-th neighbour (row-major,
    centre skipped) is below the centre. r=2 gives 24 bits."""
    img = img.to(torch.float32)
    p = _pad_edge(img, radius, radius, radius, radius)
    h, w = img.shape
    bits = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    bit = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = p[radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            bits |= (neighbor < img).to(torch.int32) << bit
            bit += 1
    return bits


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 words below 2**31 (shift/add only)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def census_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disp: int,
    min_disp: int = 0,
    block_size: int = 1,
    radius: int = 2,
) -> torch.Tensor:
    """Census + Hamming-distance cost volume (H, W, D) float32, summed
    over a block_size^2 window with edge-replicated borders."""
    cl = census_transform(left, radius)
    cr = census_transform(right, radius)
    cr_shift = _shift_right_stack(cr, min_disp, num_disp)
    ham = _popcount(cl[:, :, None] ^ cr_shift).to(torch.float32)
    return _block_sum(ham, block_size)


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg) -> torch.Tensor:
    """Dispatch on cfg.cost ('bt' | 'census').

    Census sums a cfg.block_size^2 window, as the JAX package's Pallas K1
    does (pallas_sgm.py:105-106, 293-297) and as it computes on its
    accelerator. The JAX package's XLA route (costs.cost_volume there)
    passes block_size=1 instead; the port follows the kernel."""
    if cfg.cost == "census":
        return census_cost_volume(left, right, cfg.num_disp, cfg.min_disp,
                                  cfg.block_size)
    return bt_cost_volume(left, right, cfg.num_disp, cfg.min_disp,
                          cfg.block_size, cfg.prefilter_cap)
