"""End-to-end stereo depth pipeline on PyTorch tensors.

Counterpart of depthestimation_tpu/pipeline.py (the reference's StereoCore,
stereo_core.py). Stage order mirrors _process_pair (stereo_core.py:162-200):
  cost volume -> SGM aggregation -> WTA + subpixel + LR -> in-matcher
  speckle filter -> left-band crop -> fast-mode median OR full
  postprocess -> optional WLS -> disparity->depth.

The functions below run eagerly. StereoPipeline keeps the counterpart of
the JAX package's jit cache: one entry per (config, shape, fast_mode,
downscale_factor, temporal) and the same keys for the matcher alone, the
tail behind an injected matcher and the fused rectify-and-match step. On
the card an entry is a CUDA graph of the eager function, captured on its
first call and replayed on every later one (graphs.py); on the CPU it is
the eager function itself. The matcher (its WTA stage included) and the rectification remap are
CUDA kernels on the card and their plain versions on the CPU
(ops/cuda_sgm.py, ops/wta.py, ops/remap.py). A config and shape outside the kernels'
int16 bounds or launch shapes takes the float32 route instead, as the JAX
package takes its XLA route outside Pallas (float32_disparity).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .calib import RectificationCache
from .config import SGMConfig
from .graphs import cached
from .ops import color, costs, cuda_sgm, depth as depth_ops, filters, remap, sgm, wls, wta
from .ops.cuda_build import called as _called

__all__ = ["StereoPipeline", "compute_disparity_volume", "float32_disparity",
           "check_float32_route", "raw_disparity", "postprocess_and_depth",
           "stereo_depth_fn"]

# Largest H * W * num_disp cost volume the float32 route may build on the
# card: the JAX package's limit for its XLA route on the TPU
# (_XLA_FALLBACK_LIMIT, depthestimation_tpu/pipeline.py:40). The route
# holds several float32 volumes and scans plane by plane in torch ops.
_FLOAT32_ROUTE_LIMIT = 1 << 26


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


def compute_disparity_volume(left, right, cfg: SGMConfig) -> torch.Tensor:
    """Rectified grayscale pair -> aggregated cost volume (H, W, D)
    float32, from the plain stages, as the JAX package's XLA route gives
    it (census sums the block_size^2 window, as the kernels do; see
    costs.cost_volume). The matcher's kernels compute the same sum in
    integer storage (ops/cuda_sgm.py)."""
    c = costs.cost_volume(left, right, cfg)
    return sgm.aggregate(c, cfg.p1, cfg.p2, cfg.num_paths)


def check_float32_route(cfg: SGMConfig, shape, device) -> None:
    """Raise ValueError where the float32 route may not run cfg at an
    (h, w) image on device: on the card above _FLOAT32_ROUTE_LIMIT cells,
    with the JAX package's message (depthestimation_tpu/pipeline.py:59-75).
    It runs at any size on the CPU, as JAX's does."""
    volume = shape[0] * shape[1] * cfg.num_disp
    if torch.device(device).type == "cuda" and volume > _FLOAT32_ROUTE_LIMIT:
        raise ValueError(
            "This configuration is outside the CUDA matcher's support "
            f"(cost={cfg.cost!r}, num_disp={cfg.num_disp}, "
            f"image {shape[0]}x{shape[1]}) and is too large for the float32 "
            f"matcher on the card ({volume / 2**20:.0f}M-element cost "
            "volume: expect multi-GB buffers). Use cost='bt' with num_disp "
            "small enough for int16 costs, downscale the input, or pass "
            "matcher=float32_disparity to raw_disparity to force the "
            "float32 route anyway."
        )


def float32_disparity(left, right, cfg: SGMConfig) -> torch.Tensor:
    """The float32 route: compute_disparity_volume, then the WTA stage (the
    JAX package's XLA matcher, depthestimation_tpu/pipeline.py:81-84).
    Counted as a call of "float32_route" in cuda_build.CALLS on every
    device; on the card its only kernel is the WTA stage's
    (wta.wta_disparity, on the rounded int32 volume)."""
    _called("float32_route")
    s = compute_disparity_volume(left, right, cfg)
    return wta.wta_disparity(s, cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff)


def raw_disparity(left, right, cfg: SGMConfig, matcher=None):
    """Full matcher: prefilter/cost/aggregate/WTA, then the in-matcher
    speckle filter. Output float32 (H, W) disparity in pixels on the 1/16
    grid; invalid = min_disp - 1.

    The route follows from cfg and the image's shape, as in the JAX
    package: the kernels (cuda_sgm.sgm_disparity) wherever
    cuda_sgm.kernels_supported holds, else the float32 route
    (float32_disparity, within check_float32_route's limit). `matcher`,
    the (left, right, cfg) -> disparity stage, replaces that choice, to
    compare kernels with plain versions."""
    if matcher is None:
        shape = tuple(left.shape)
        if cuda_sgm.kernels_supported(cfg, shape):
            matcher = cuda_sgm.sgm_disparity
        else:
            check_float32_route(cfg, shape, left.device)
            matcher = float32_disparity
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


def _rectify(left, right, cfg: SGMConfig, maps):
    """Raw pair (RGB or gray, any dtype) -> rectified float32 grayscale
    pair (JAX pipeline.py:210-245): grayscale, the bilinear resize of an
    image that differs from the calibration size, then one remap launch
    for both images through maps = (map_x, map_y), each (2, H, W)."""
    size_hw = (cfg.calib.image_height, cfg.calib.image_width)
    gray = [color.to_grayscale(img).to(torch.float32) for img in (left, right)]
    gray = [g if tuple(g.shape) == size_hw else color.resize_bilinear(g, size_hw)
            for g in gray]
    rect = remap.remap_bilinear(torch.stack(gray), *maps)
    return rect[0], rect[1]


class StereoPipeline:
    """Stateful facade over the pipeline (the StereoCore equivalent).

    Holds the frozen config, the device, the cache of compiled programs (a
    CUDA graph per key on the card, module docstring), a
    rectification-map cache and the temporal-smoother carry. device
    defaults to "cuda" and raises RuntimeError when no card is usable;
    pass device="cpu" for the plain versions.
    """

    def __init__(self, cfg: Optional[SGMConfig] = None, downscale_factor: float = 1.0,
                 fast_mode: bool = False, device="cuda"):
        self.cfg = cfg or SGMConfig()
        self.downscale_factor = downscale_factor
        self.fast_mode = fast_mode
        self.device = _resolve_device(device)
        self._rect_cache = RectificationCache()
        self._graph_cache = {}
        self._prev_disp = None  # temporal-smoother state (device tensor)
        self.disparity_map = None
        self.depth_map = None
        self.left_rectified = None
        self.right_rectified = None

    # -- config management (configure_sgbm parity, stereo_core.py:77-123) --
    def configure(self, **kwargs) -> None:
        self.cfg = self.cfg.updated(downscale_factor=self.downscale_factor, **kwargs)
        # JAX keeps the old configs' entries. A graph's pool holds its
        # frame's whole working set (GBs at 1080p), so only the new
        # config's entries stay.
        self._graph_cache = {k: v for k, v in self._graph_cache.items() if self.cfg in k}
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
        left, right = self._tensor(left_img), self._tensor(right_img)
        if not cfg.has_full_calibration():
            return (color.to_grayscale(left).to(torch.float32),
                    color.to_grayscale(right).to(torch.float32))
        self._warn_size(left, right)
        return _rectify(left, right, cfg, self._maps())

    def _maps(self):
        return self._rect_cache.device_maps(self.cfg.calib, self.cfg.baseline, 1.0,
                                            self.device)

    def _warn_size(self, left, right):
        """Reference parity: rectify.py:99-104 warns before resizing an
        image that disagrees with the calibration size."""
        size_hw = (self.cfg.calib.image_height, self.cfg.calib.image_width)
        if tuple(left.shape[:2]) != size_hw or tuple(right.shape[:2]) != size_hw:
            warnings.warn(
                f"Image size {tuple(left.shape[:2])} does not match "
                f"calibration size {size_hw}; resizing to match.",
                RuntimeWarning,
                stacklevel=3,
            )

    # -- the compiled-program cache (JAX pipeline.py:248-345) --
    def _entry(self, key, fn, name):
        """The cache's entry for key, made from fn on first use: a CUDA
        graph of fn on the card, fn itself on the CPU."""
        return cached(self._graph_cache, key, fn, name, self.device)

    def _get_graphed(self, shape, temporal=False):
        """stereo_depth_fn on a rectified grayscale pair (and the previous
        cropped disparity when temporal): JAX's _get_jitted."""
        key = (self.cfg, shape, self.fast_mode, self.downscale_factor, temporal)
        cfg, ds, fm = self.cfg, self.downscale_factor, self.fast_mode

        def run(left, right, prev_disp=None):
            return stereo_depth_fn(left, right, cfg, ds, fm, prev_disp=prev_disp)

        return self._entry(key, run, "stereo_depth_fn")

    def _get_post_graphed(self, shape, temporal=False):
        """postprocess_and_depth behind an injected matcher, the guide (the
        rectified left image) riding along for WLS: JAX's
        _get_post_jitted."""
        key = ("post", self.cfg, shape, self.fast_mode, self.downscale_factor, temporal)
        cfg, ds, fm = self.cfg, self.downscale_factor, self.fast_mode

        def run(disp, guide, prev_disp=None):
            return postprocess_and_depth(disp, cfg, ds, fm, guide=guide, prev_disp=prev_disp)

        return self._entry(key, run, "postprocess_and_depth")

    def _get_rect_graphed(self, shape, temporal=False):
        """Grayscale, resize, remap, matcher and tail from the raw pair as
        one replay: JAX's _get_rect_jitted. `shape` is the raw pair's
        shapes and dtypes (jax.jit keys on both through its arguments)."""
        key = ("rect", self.cfg, shape, self.fast_mode, self.downscale_factor, temporal)
        cfg, ds, fm = self.cfg, self.downscale_factor, self.fast_mode
        # The entry holds the maps: its graph reads their memory.
        maps = self._maps()

        def run(left, right, prev_disp=None):
            rl, rr = _rectify(left, right, cfg, maps)
            return stereo_depth_fn(rl, rr, cfg, ds, fm, prev_disp=prev_disp)

        return self._entry(key, run, "rectify + stereo_depth_fn")

    def compute_disparity(self, rectified_l, rectified_r):
        """Matcher-only stage (compute_disparity parity,
        stereo_core.py:212-232): the reference's injectable test seam. An
        instance attribute of this name replaces the matcher in
        process_pair and keeps the postprocess/depth tail."""
        left = self._tensor(rectified_l).to(torch.float32)
        right = self._tensor(rectified_r).to(torch.float32)
        cfg = self.cfg
        return self._entry(("matcher", cfg, tuple(left.shape)),
                           lambda l, r: raw_disparity(l, r, cfg), "raw_disparity")(left, right)

    def process_pair_async(self, left_rect, right_rect):
        """Like process_pair, but returns the tensors (disparity, depth or
        None) on the pipeline's device without waiting for the card, so
        the streaming facade enqueues frame N+1 while frame N runs
        (depthestimation_tpu/pipeline.py:348-376).

        Carries the temporal-smoothing state (cfg.temporal_alpha) across
        calls on the same stream of the card; reset_temporal() clears it.
        If compute_disparity has been replaced on the instance (the
        reference's injectable fake-matcher seam,
        tests/test_postproc_logic.py:19,28), the override feeds the
        postprocess/depth tail.
        """
        left = self._tensor(left_rect).to(torch.float32)
        right = self._tensor(right_rect).to(torch.float32)
        prev = self._prev()
        if "compute_disparity" in self.__dict__:
            disp = self._tensor(self.compute_disparity(left, right)).to(torch.float32)
            out = self._get_post_graphed(tuple(disp.shape), bool(prev))(disp, left, *prev)
        else:
            out = self._get_graphed(tuple(left.shape), bool(prev))(left, right, *prev)
        return self._carry(out)

    def _prev(self):
        """(the previous frame's disparity,) for the temporal entry, or ()
        for the first frame and without the smoother."""
        if self.cfg.temporal_alpha > 0 and self._prev_disp is not None:
            return (self._prev_disp,)
        return ()

    def _carry(self, out):
        """Keep the frame's disparity for the temporal smoother."""
        if self.cfg.temporal_alpha > 0:
            self._prev_disp = out[0]
        return out

    def process_pair(self, left_rect, right_rect):
        """Full pipeline on an already-rectified pair (_process_pair
        parity, stereo_core.py:162-200): process_pair_async, then the
        host copy. Returns host numpy arrays (disparity, depth or None)
        and keeps them on the instance."""
        disp, depth_m = self.process_pair_async(left_rect, right_rect)
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

    def estimate_depth_async(self, left_source, right_source):
        """estimate_depth without the device->host copy: the tensors
        (disparity, depth or None) on the pipeline's device, so the caller
        can enqueue the next frame first (depthestimation_tpu/
        pipeline.py:408-436). With full calibration (and no injected
        matcher) grayscale, the resize after its RuntimeWarning, the remap
        and the rest run as one entry of the cache; nothing on the way
        waits for the card."""
        if self.cfg.has_full_calibration() and "compute_disparity" not in self.__dict__:
            left, right = self._tensor(left_source), self._tensor(right_source)
            self._warn_size(left, right)
            prev = self._prev()
            shape = tuple((tuple(t.shape), t.dtype) for t in (left, right))
            return self._carry(self._get_rect_graphed(shape, bool(prev))(left, right, *prev))
        left_r, right_r = self.prepare_rectified(left_source, right_source)
        return self.process_pair_async(left_r, right_r)
