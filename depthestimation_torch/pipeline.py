"""End-to-end stereo depth pipeline on PyTorch tensors.

Counterpart of depthestimation_tpu/pipeline.py (the reference's StereoCore,
stereo_core.py). Stage order mirrors _process_pair (stereo_core.py:162-200):
  cost volume -> SGM aggregation -> WTA + subpixel + LR -> in-matcher
  speckle filter -> left-band crop -> fast-mode median OR full
  postprocess -> optional WLS -> disparity->depth.

PyTorch runs eagerly, so there is no compilation cache: every call runs
the stages directly on the pipeline's device. The matcher and the
rectification remap are CUDA kernels on the card and their plain versions
on the CPU (ops/cuda_sgm.py, ops/remap.py).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .calib import RectificationCache
from .config import SGMConfig
from .ops import color, cuda_sgm, depth as depth_ops, filters, remap, wls

__all__ = ["StereoPipeline", "raw_disparity", "postprocess_and_depth",
           "stereo_depth_fn"]


def _resolve_device(device) -> torch.device:
    """The device the entry points compute on. A CUDA device without a
    usable card raises instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return device


def raw_disparity(left, right, cfg: SGMConfig, matcher=cuda_sgm.sgm_disparity):
    """Full matcher: prefilter/cost/aggregate/WTA, then the in-matcher
    speckle filter. Output float32 (H, W) disparity in pixels on the 1/16
    grid; invalid = min_disp - 1. `matcher` is the (left, right, cfg) ->
    disparity stage, replaceable to compare kernels with plain versions."""
    disp = matcher(left, right, cfg)
    if cfg.speckle_window_size > 0:
        # cv2.StereoSGBM runs filterSpeckles inside compute() on the x16
        # fixed-point grid with newVal=(minDisparity-1)*16 and
        # maxDiff=16*speckleRange; on the /16 grid that is
        # new_val=min_disp-1, max_diff=speckle_range.
        disp = filters.filter_speckles(
            disp,
            new_val=float(cfg.min_disp - 1),
            max_speckle_size=cfg.speckle_window_size,
            max_diff=float(cfg.speckle_range),
        )
    return disp


def postprocess_and_depth(
    disp,
    cfg: SGMConfig,
    downscale_factor: float = 1.0,
    fast_mode: bool = False,
    guide=None,
    prev_disp=None,
):
    """Crop + postprocess + depth on a raw (uncropped) disparity map
    (the tail of _process_pair, stereo_core.py:166-196).

    guide: the rectified left image, enabling the WLS-style refinement
    (cfg.wls_filter). prev_disp: previous cropped disparity for the
    temporal smoother (cfg.temporal_alpha > 0).
    """
    # Crop the invalid left band (stereo_core.py:168).
    disp = disp[:, cfg.num_disp:]

    if fast_mode:
        # Fast mode: 3x3 median only (stereo_core.py:171-173).
        disp = filters.median3x3(disp)
    else:
        disp = filters.postprocess_disparity(
            disp,
            max_speckle_size=int(100 * downscale_factor),
            max_diff=1.0,
            outlier_threshold=2.5,
            fill_method="inpaint",
            apply_outlier_removal=True,
            apply_hole_filling=cfg.hole_filling,
        )

    if cfg.wls_filter and guide is not None:
        disp = wls.wls_refine(
            disp, guide[:, cfg.num_disp:],
            radius=cfg.wls_radius, eps=cfg.wls_eps,
        )
    if cfg.temporal_alpha > 0 and prev_disp is not None:
        disp = wls.temporal_smooth(
            disp, prev_disp, alpha=cfg.temporal_alpha,
            max_change=cfg.temporal_max_change,
        )

    depth_m = None
    if cfg.focal_length is not None and cfg.baseline is not None:
        # Reference quirk kept: eps = min_disp (stereo_core.py:189,194).
        depth_m = depth_ops.disparity_to_depth(
            disp,
            cfg.focal_length,
            cfg.baseline,
            cfg.doffs,
            eps=float(cfg.min_disp),
            max_depth=cfg.max_depth,
        )
    return disp, depth_m


def stereo_depth_fn(
    left,
    right,
    cfg: SGMConfig,
    downscale_factor: float = 1.0,
    fast_mode: bool = False,
    prev_disp=None,
):
    """The per-pair pipeline on a rectified grayscale pair.

    Returns (disparity_px, depth_m_or_None); disparity width is
    W - num_disp after the left-band crop.
    """
    disp = raw_disparity(left, right, cfg)
    return postprocess_and_depth(disp, cfg, downscale_factor, fast_mode,
                                 guide=left, prev_disp=prev_disp)


class StereoPipeline:
    """Stateful facade over the pipeline (the StereoCore equivalent).

    Holds the frozen config, the device, a rectification-map cache and the
    temporal-smoother carry. device defaults to "cuda" and raises RuntimeError when no card is
    usable; pass device="cpu" for the plain versions.
    """

    def __init__(self, cfg: Optional[SGMConfig] = None, downscale_factor: float = 1.0,
                 fast_mode: bool = False, device="cuda"):
        self.cfg = cfg or SGMConfig()
        self.downscale_factor = downscale_factor
        self.fast_mode = fast_mode
        self.device = _resolve_device(device)
        self._rect_cache = RectificationCache()
        self._prev_disp = None  # temporal-smoother state (device tensor)
        self.disparity_map = None
        self.depth_map = None
        self.left_rectified = None
        self.right_rectified = None

    # -- config management (configure_sgbm parity, stereo_core.py:77-123) --
    def configure(self, **kwargs) -> None:
        self.cfg = self.cfg.updated(downscale_factor=self.downscale_factor, **kwargs)
        # The temporal carry has the old config's crop width.
        self.reset_temporal()

    def get_params(self) -> dict:
        return self.cfg.as_reference_dict()

    def reset_temporal(self):
        self._prev_disp = None

    def _tensor(self, img) -> torch.Tensor:
        """A tensor or array-like on the pipeline's device."""
        if torch.is_tensor(img):
            return img.to(self.device)
        return torch.tensor(np.asarray(img), device=self.device)

    def prepare_rectified(self, left_img, right_img):
        """Grayscale float32 pair on the pipeline's device, rectified when
        full calibration is present (stereo_core.py:138-160; JAX
        pipeline.py:210-245): grayscale, resize to the calibration size
        after a RuntimeWarning if an image differs from it, then one remap
        launch for both images through the cached device maps."""
        cfg = self.cfg
        gray = [color.to_grayscale(self._tensor(img)).to(torch.float32)
                for img in (left_img, right_img)]
        if not cfg.has_full_calibration():
            return gray[0], gray[1]
        size_hw = (cfg.calib.image_height, cfg.calib.image_width)
        if any(tuple(g.shape) != size_hw for g in gray):
            # Reference parity: rectify.py:99-104 warns before resizing an
            # image that disagrees with the calibration size.
            warnings.warn(
                f"Image size {tuple(gray[0].shape)} does not match "
                f"calibration size {size_hw}; resizing to match.",
                RuntimeWarning,
                stacklevel=2,
            )
            gray = [g if tuple(g.shape) == size_hw
                    else color.resize_bilinear(g, size_hw) for g in gray]
        map_x, map_y = self._rect_cache.device_maps(
            cfg.calib, cfg.baseline, 1.0, self.device)
        rect = remap.remap_bilinear(torch.stack(gray), map_x, map_y)
        return rect[0], rect[1]

    def compute_disparity(self, rectified_l, rectified_r):
        """Matcher-only stage (compute_disparity parity,
        stereo_core.py:212-232): the reference's injectable test seam. An
        instance attribute of this name replaces the matcher in
        process_pair and keeps the postprocess/depth tail."""
        left = self._tensor(rectified_l).to(torch.float32)
        right = self._tensor(rectified_r).to(torch.float32)
        return raw_disparity(left, right, self.cfg)

    def process_pair(self, left_rect, right_rect):
        """Full pipeline on an already-rectified pair (_process_pair
        parity, stereo_core.py:162-200). Returns host numpy arrays
        (disparity, depth or None) and keeps them on the instance."""
        left = self._tensor(left_rect).to(torch.float32)
        right = self._tensor(right_rect).to(torch.float32)
        prev = self._prev_disp if self.cfg.temporal_alpha > 0 else None
        if "compute_disparity" in self.__dict__:
            disp = self._tensor(self.compute_disparity(left, right)).to(torch.float32)
        else:
            disp = raw_disparity(left, right, self.cfg)
        disp, depth_m = postprocess_and_depth(
            disp, self.cfg, self.downscale_factor, self.fast_mode,
            guide=left, prev_disp=prev,
        )
        if self.cfg.temporal_alpha > 0:
            self._prev_disp = disp
        self.disparity_map = disp.cpu().numpy()
        self.depth_map = None if depth_m is None else depth_m.cpu().numpy()
        return self.disparity_map, self.depth_map

    def estimate_depth(self, left_source, right_source):
        """Raw images -> grayscale -> disparity -> depth
        (estimate_depth parity, stereo_core.py:274-293)."""
        if left_source is None or right_source is None:
            raise ValueError(
                "Left and right sources must be set before estimating depth."
            )
        self.left_rectified, self.right_rectified = self.prepare_rectified(
            left_source, right_source
        )
        return self.process_pair(self.left_rectified, self.right_rectified)
