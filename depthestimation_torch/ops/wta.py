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
  disables). Above 256 disparities this differs from the JAX version on
  purpose: its claim key cost*256 + d0 decodes d0 with & 255, so there it
  invalidates every pixel whose d0 is 256 or more; the key here is
  cost << shift | d0 with the argmin's shift;
- invalid marker = min_disp - 1.

The volume here is never padded, so the JAX version's num_disp/crop
arguments (pad-lane and pad-column masks) have no counterpart.

wta_disparity takes a volume on the CPU through wta_disparity_plain and
launches one kernel for a volume on the card (csrc/wta_kernels.cu: argmin,
uniqueness, subpixel and the LR check, one block a row), equal to the
plain version bit for bit; it never falls back. Each call on the card adds
one to LAUNCHES["wta"] and to CALLS["wta"] (cuda_build). lr_invalidate
stays plain: parallel/shard.py runs it on a selection gathered across
ranks.
"""

from __future__ import annotations

import torch

from .cuda_build import (called as _called, check as _check,
                         launched as _launched, load_library,
                         on_card as _on_card, stream as _stream)

__all__ = ["wta_disparity", "wta_disparity_plain", "lr_invalidate"]

_BIG = 2**20


def lr_invalidate(d0, min_s, valid, disp12_max_diff, min_disp, num_disp):
    """OpenCV-style LR consistency on (H, W) int32 maps; True = fails.

    disp2[xr] = d0 of the minimum-cost claimant x with x - d0(x) = xr; a
    pixel fails when |disp2[x - d0] - d0| > disp12_max_diff, including when
    its right pixel has no claimant or falls outside the image.

    The claimants of right pixel xr are x = xr + d + min_disp for d in
    [0, D), so the scatter-min becomes a shift loop over d on a packed key
    cost << shift | d0, which orders by (cost, d): ascending d with a
    strict '<' update, OpenCV's tie-break. shift is wta_disparity's,
    max(8, bits of D - 1), so d0 always fits below it.

    Up to 256 disparities the key is the JAX version's int32 cost*256 + d0
    (bit for bit): the kernels' largest final sum, 8 paths of at most
    32600, times 256 stays below noclaim = 2^29. Above 256 the key is
    int64, with noclaim = 2^61: a real key is below 2^(31 + shift), so it
    stays under noclaim up to shift 30, i.e. past any D a card can hold.
    """
    h, w = d0.shape
    dev = d0.device
    pad_r = num_disp + min_disp
    shift = max(8, (num_disp - 1).bit_length())
    dtype = torch.int32 if shift == 8 else torch.int64
    noclaim = 1 << (29 if shift == 8 else 61)
    none = 2 * noclaim  # "no candidate", above noclaim
    low = (1 << shift) - 1
    key = torch.where(valid, min_s.to(dtype) * (1 << shift) + d0, noclaim).to(dtype)
    key_pad = torch.cat(
        [key, torch.full((h, pad_r), noclaim, dtype=dtype, device=dev)], 1
    )
    packed2 = torch.full((h, w), none, dtype=dtype, device=dev)
    for d in range(num_disp):
        off = d + min_disp
        cand = key_pad[:, off:off + w]
        cand = torch.where((cand & low) == d, cand, none)
        packed2 = torch.minimum(packed2, cand)
    disp2 = torch.where(packed2 >= noclaim, _BIG, packed2 & low).to(torch.int32)

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
    """Select disparity from aggregated volume S (H, W, D): float32 (H, W)
    disparity on the 1/16 grid, invalid = min_disp - 1; wta_disparity_plain's
    semantics, bit for bit. On the card one launch of the WTA kernel on the
    int16 or int32 volume (a float volume is rounded to int32 first, as the
    plain version does)."""
    if not _on_card(s):
        return wta_disparity_plain(s, min_disp, uniqueness_ratio, disp12_max_diff)
    if s.dtype.is_floating_point:
        s = torch.round(s).to(torch.int32)
    if s.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"s has dtype {s.dtype}, expected int16, int32 or floating")
    if s.ndim != 3:
        raise ValueError(f"s must be (H, W, D), not {tuple(s.shape)}")
    s = s.contiguous()
    _check(s, "s", s.dtype, s.shape, s.device)
    params = (int(min_disp), int(uniqueness_ratio), int(disp12_max_diff))
    if not all(-2**31 <= p < 2**31 for p in params):
        raise ValueError(f"min_disp, uniqueness_ratio and disp12_max_diff {params} "
                         "must fit in 32 bits")
    h, w, d = s.shape
    out = torch.empty((h, w), dtype=torch.float32, device=s.device)
    _launched("wta", load_library().wta_select(
        s.data_ptr(), int(s.dtype == torch.int32), out.data_ptr(), h, w, d, *params,
        float(min_disp - 1), _stream()))
    _called("wta")
    return out


def wta_disparity_plain(
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
