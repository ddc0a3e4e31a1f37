"""Winner-take-all disparity selection with sub-pixel refinement,
uniqueness-ratio test and left-right consistency check (plain PyTorch).

Counterpart of depthestimation_tpu/ops/wta.py (the selection stage of
cv2.StereoSGBM, reference stereo_core.py:63-75):

- argmin over D on the aggregated volume S, smallest d on ties;
- uniqueness: pixel invalidated when some non-neighbor candidate d
  (|d - d0| > 1) has S[d]*(100 - uniquenessRatio) < minS*100;
- quadratic sub-pixel interpolation with OpenCV's integer rounding on the
  1/16 fixed-point grid (stereo_core.py:232);
- left-right consistency as OpenCV computes it: the right-view disparity
  is a min-cost claim of the chosen (minS, d0) pairs onto right pixels
  xr = x - d0 (uniqueness survivors only), then pixels with
  |d_R(x - d0) - d0| > disp12_max_diff are invalidated (negative
  disables);
- invalid marker = min_disp - 1.

The volume here is never padded, so the JAX version's num_disp/crop
arguments (pad-lane and pad-column masks) have no counterpart.
"""

from __future__ import annotations

import torch

__all__ = ["wta_disparity", "lr_invalidate"]

_BIG = 2**20


def lr_invalidate(d0, min_s, valid, disp12_max_diff, min_disp, num_disp):
    """OpenCV-style LR consistency on (H, W) int32 maps; True = fails.

    disp2[xr] = d0 of the minimum-cost claimant x with x - d0(x) = xr; a
    pixel fails when |disp2[x - d0] - d0| > disp12_max_diff, including when
    its right pixel has no claimant or falls outside the image.

    The claimants of right pixel xr are x = xr + d + min_disp for d in
    [0, D), so the scatter-min becomes a shift loop over d on a packed key
    cost*256 + d0, which orders by (cost, d): ascending d with a strict '<'
    update, OpenCV's tie-break (d0 < 256 always).
    """
    h, w = d0.shape
    dev = d0.device
    pad_r = num_disp + min_disp
    noclaim = 1 << 29
    key = torch.where(valid, min_s * 256 + d0, noclaim).to(torch.int32)
    key_pad = torch.cat(
        [key, torch.full((h, pad_r), noclaim, dtype=torch.int32, device=dev)], 1
    )
    packed2 = torch.full((h, w), 1 << 30, dtype=torch.int32, device=dev)
    for d in range(num_disp):
        off = d + min_disp
        cand = key_pad[:, off:off + w]
        cand = torch.where((cand & 255) == d, cand, 1 << 30)
        packed2 = torch.minimum(packed2, cand)
    disp2 = torch.where(packed2 >= noclaim, _BIG, packed2 & 255)

    # Check phase: pixel x with index d reads disp2[x - d - min_disp]
    # (left pad = out of bounds = bad).
    d2_pad = torch.cat(
        [torch.full((h, pad_r), -_BIG, dtype=disp2.dtype, device=dev), disp2], 1
    )
    bad = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for d in range(num_disp):
        off = d + min_disp
        dr_at = d2_pad[:, pad_r - off:pad_r - off + w]
        bad = bad | ((d0 == d) & (torch.abs(dr_at - d) > disp12_max_diff))
    return bad


def wta_disparity(
    s: torch.Tensor,
    min_disp: int = 0,
    uniqueness_ratio: int = 10,
    disp12_max_diff: int = 1,
) -> torch.Tensor:
    """Select disparity from aggregated volume S (H, W, D).

    Returns float32 (H, W) disparity in pixels (including min_disp and the
    /16 sub-pixel quantization); invalid pixels = min_disp - 1.
    """
    if s.dtype.is_floating_point:
        s = torch.round(s).to(torch.int32)
    num_d = s.shape[-1]
    dev = s.device
    d_idx = torch.arange(num_d, dtype=torch.int32, device=dev)
    # Sentinel above every real cost: int16 volumes bound real costs to
    # <= 32600 (cuda_sgm._final_dtype), so int16 max works there.
    sent = torch.iinfo(torch.int16).max if s.dtype == torch.int16 else _BIG

    # min + argmin in one packed-key reduction: key = cost << shift | d
    # orders by (cost, d), so ties go to the smallest d (argmin's first
    # index, OpenCV's rule).
    shift = max(8, (num_d - 1).bit_length())
    pmin = (s.to(torch.int32) * (1 << shift) + d_idx).amin(dim=-1)
    min_s = pmin >> shift
    d0 = pmin & ((1 << shift) - 1)

    def at(dd):
        """S[..., dd] per pixel, sentinel where dd is outside [0, D)."""
        inside = (dd >= 0) & (dd < num_d)
        g = torch.gather(s, -1, dd.clamp(0, num_d - 1)[..., None].long())[..., 0]
        return torch.where(inside, g.to(torch.int32), sent)

    cm = at(d0 - 1)
    cp = at(d0 + 1)

    invalid = torch.zeros(d0.shape, dtype=torch.bool, device=dev)
    if uniqueness_ratio > 0:
        near = torch.abs(d_idx - d0[..., None]) <= 1
        competitor = torch.where(
            near, torch.full((), sent, dtype=s.dtype, device=dev), s
        ).amin(dim=-1).to(torch.int32)
        invalid = competitor * (100 - uniqueness_ratio) < min_s * 100

    if disp12_max_diff >= 0:
        invalid = invalid | lr_invalidate(
            d0, min_s, ~invalid, disp12_max_diff, min_disp, num_d
        )

    # OpenCV integer subpixel: d*16 + ((cm - cp)*16 + denom) / (2*denom)
    # with C truncating division.
    denom = torch.clamp(cm + cp - 2 * min_s, min=1)
    delta16 = torch.div((cm - cp) * 16 + denom, 2 * denom, rounding_mode="trunc")
    interior = (d0 > 0) & (d0 < num_d - 1)
    delta16 = torch.where(interior, delta16, 0)
    disp = ((min_disp + d0) * 16 + delta16).to(torch.float32) / 16.0
    return torch.where(
        invalid, torch.full((), float(min_disp - 1), device=dev), disp
    )
