"""User-facing estimator facades (counterpart of depthestimation_tpu/api.py).

API-capability parity with the reference's StereoDepthEstimator,
StereoDepthEstimatorVideo and MonocularDepthEstimator
(depthlib/StereoDepthEstimator.py, StereoDepthEstimatorVideo.py,
MonocularDepthEstimator.py).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import viz
from .graphs import CapturedCall
from .io.input import _area_downscale_np, load_image, load_stereo_pair, stereo_stream
from .io.threaded import PairStager, StereoInputPipeline
from .metrics import MetricsAggregator, frame_metrics_from_stats
from .pipeline import StereoPipeline, _resolve_device

__all__ = ["StereoDepthEstimator", "StereoDepthEstimatorVideo", "MonocularDepthEstimator"]


class StereoDepthEstimator:
    """Single stereo pair -> (disparity, depth).

    Parity: depthlib/StereoDepthEstimator.py:10-123 -- validates
    downscale_factor in (0, 1], loads + downscales the pair at init,
    delegates to the pipeline core, keeps disparity_map/depth_map.
    device defaults to "cuda" and raises RuntimeError when no card is
    usable; pass device="cpu" for the plain versions.
    """

    def __init__(self, left_source=None, right_source=None, downscale_factor=1.0,
                 device="cuda"):
        if downscale_factor <= 0 or downscale_factor > 1.0:
            raise ValueError("downscale_factor must be between 0 and 1.")
        self.downscale_factor = downscale_factor
        self.core = StereoPipeline(downscale_factor=downscale_factor, device=device)

        self.left_source = None
        self.right_source = None
        if left_source is not None and right_source is not None:
            self.left_source, self.right_source = load_stereo_pair(
                left_source, right_source, downscale_factor=downscale_factor
            )
        self.disparity_map = None
        self.depth_map = None

    def configure_sgbm(self, **kwargs):
        """Configure matcher parameters (configure_sgbm parity; scaling
        semantics in SGMConfig.updated)."""
        self.core.configure(**kwargs)

    def get_sgbm_params(self) -> Dict:
        return self.core.get_params()

    def estimate_depth(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.left_source is None or self.right_source is None:
            raise ValueError(
                "Left and right sources must be provided for depth estimation."
            )
        disparity_px, depth_m = self.core.estimate_depth(
            self.left_source, self.right_source
        )
        self.disparity_map = disparity_px
        self.depth_map = depth_m
        return disparity_px, depth_m

    def visualize_results(self):
        if self.disparity_map is None:
            raise ValueError(
                "Disparity map not computed. Call estimate_depth() first."
            )
        viz.visualize_disparity(self.disparity_map, title="Disparity Map (Raw)",
                                cmap="jet")
        if self.depth_map is None:
            raise ValueError(
                "Depth map not computed. Call estimate_depth() with calibration "
                "data first."
            )
        viz.visualize_depth(self.depth_map, title="Depth Map (Raw)", cmap="turbo_r")


class StereoDepthEstimatorVideo:
    """Streaming generator over synchronized stereo sources.

    Parity: depthlib/StereoDepthEstimatorVideo.py:12-148 -- threaded or
    sequential capture, live visualization, FPS throttle, fast_mode,
    drop_frames; yields a depth map per frame (host numpy, depth_dtype).

    device defaults to "cuda" and raises RuntimeError when no card is
    usable; pass device="cpu" for the plain versions. On the card, frames
    are staged into its memory on a side stream (by the input thread, or
    here when use_threading=False), each frame is one replay of the
    pipeline's CUDA graph and one of the stats graph (pipeline.py,
    graphs.py; the first frame of a shape captures them), frame N+1 is
    enqueued before frame N is read back, and each frame's depth and
    disparity stats come back through non-blocking copies into pinned host
    memory, waited on by an event only when the frame is yielded.
    """

    def __init__(
        self,
        left_source=None,
        right_source=None,
        downscale_factor=1.0,
        visualize_live=False,
        saving_path=None,
        fast_mode=False,
        use_threading=True,
        target_fps=30,
        drop_frames=False,
        visualize_gray=False,
        depth_dtype="float32",
        device="cuda",
    ) -> None:
        self.left_source = left_source
        self.right_source = right_source
        self.downscale_factor = downscale_factor
        self.visualize_live = visualize_live
        self.saving_path = saving_path
        self.fast_mode = fast_mode
        self.use_threading = use_threading
        self.target_fps = target_fps
        self._frame_interval = 1.0 / target_fps if target_fps > 0 else 0
        self.drop_frames = drop_frames
        self.visualize_gray = visualize_gray
        # Host-link budget lever: depth maps come back as this dtype --
        # 'float16' halves the per-frame D2H bytes (depth display and
        # consumers downstream quantize far coarser).
        self.depth_dtype = str(depth_dtype)
        if self.depth_dtype not in ("float32", "float16"):
            raise ValueError("depth_dtype must be 'float32' or 'float16'.")
        self.core = StereoPipeline(
            downscale_factor=downscale_factor, fast_mode=fast_mode, device=device
        )
        self.device = self.core.device
        # Observability (SURVEY.md section 5): rolling per-frame metrics,
        # refreshed on every estimate_depth() run.
        self.metrics = MetricsAggregator()
        self._stop_requested = False
        self._stats_cache = {}

    # Consecutive compute/readback failures tolerated by the per-frame
    # error isolation before the stream is declared broken -- the consumer
    # analogue of StereoInputPipeline.MAX_CONSECUTIVE_FAILURES, so a
    # persistently failing config on a live camera raises instead of
    # silently yielding nothing forever.
    MAX_CONSECUTIVE_FAILURES = 8

    def stop(self):
        """Request the streaming generator to exit after the current
        frame -- the programmatic equivalent of the reference's ESC exit
        (StereoDepthEstimatorVideo.py:111-112); the live window's ESC key
        sets the same flag."""
        self._stop_requested = True

    def configure_sgbm(self, **kwargs):
        self.core.configure(**kwargs)

    def get_sgbm_params(self) -> Dict:
        return self.core.get_params()

    @staticmethod
    def _disp_stats(disp):
        """(valid_fraction, min, max, mean-over-valid) of a disparity map,
        computed on its device as one 4-element float32 tensor -- 16
        bytes to read back instead of the whole map."""
        d = disp.to(torch.float32)
        valid = d > 0
        n = torch.clamp(valid.sum(), min=1)
        big = 3.4e38
        return torch.stack([
            valid.to(torch.float32).mean(),
            torch.where(valid, d, big).amin(),
            torch.where(valid, d, -big).amax(),
            torch.where(valid, d, 0.0).sum() / n,
        ])

    def _frame_out(self, disp, depth):
        """The frame's stats and depth as they go to the host: the
        stats, and the depth cast to depth_dtype (None without one). One
        entry per shape (JAX's jitted stats, api.py:157-178): a CUDA graph
        on the card, the eager function on the CPU."""
        cast = depth is not None and self.depth_dtype == "float16"
        args = (disp, depth) if cast else (disp,)
        key = tuple(tuple(t.shape) for t in args)
        fn = self._stats_cache.get(key)
        if fn is None:
            def fn(disp, depth=None):
                stats = StereoDepthEstimatorVideo._disp_stats(disp)
                return (stats,) if depth is None else (stats, depth.to(torch.float16))

            if self.device.type == "cuda":
                fn = CapturedCall(fn, "frame stats")
            self._stats_cache[key] = fn
        out = fn(*args)
        return out[0], (out[1] if cast else depth)

    def _readback(self, disp, depth):
        """Enqueue the frame's stats and depth (cast to depth_dtype) for
        the host: (stats, depth or None, event). On the card both are
        non-blocking copies into fresh pinned buffers behind the returned
        event, which the caller waits on before reading them; a yielded
        depth map keeps its buffer, so no later frame overwrites it."""
        stats, depth = self._frame_out(disp, depth)
        if self.device.type != "cuda":
            return stats, depth, None
        host = []
        for t in (stats, depth):
            if t is not None:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                t = h.copy_(t, non_blocking=True)
            host.append(t)
        done = torch.cuda.Event()
        done.record()
        return host[0], host[1], done

    def _emit(self, depth_m, measured_fps):
        if self.visualize_live:
            if self.visualize_gray:
                viz.visualize_depth_live_gray(depth_m, measured_fps)
            else:
                viz.visualize_depth_live(depth_m, measured_fps)

    def _frames(self):
        """Synchronized frame pairs: staged on the card by the input
        thread (use_threading), else host arrays (staged by
        estimate_depth on the card)."""
        if self.use_threading:
            pipe = StereoInputPipeline(
                self.left_source,
                self.right_source,
                downscale_factor=self.downscale_factor,
                drop_frames=self.drop_frames,
                device=self.device if self.device.type == "cuda" else None,
            )
            pipe.start()
            try:
                yield from pipe
            finally:
                pipe.stop()
        else:
            yield from stereo_stream(
                self.left_source, self.right_source,
                downscale_factor=self.downscale_factor,
            )

    def estimate_depth(self):
        """Yield a depth map (meters) per synchronized frame pair.

        Frame N+1 is enqueued on the card before frame N is read back to
        the host, so capture, H2D, compute and D2H overlap (the
        reference's thread only overlapped capture with compute).
        """
        if self.left_source is None or self.right_source is None:
            raise ValueError(
                "Both left_source and right_source must be provided for video "
                "depth estimation."
            )

        self.metrics = MetricsAggregator()
        self.core.reset_temporal()
        self._stop_requested = False
        # The sequential path stages each pair itself (same copy stream
        # and pinned ring as the input thread), inside the frame's error
        # isolation.
        stager = None
        if not self.use_threading and self.device.type == "cuda":
            stager = PairStager(self.device)

        # Per-stream ESC wiring: the live window invokes this listener, so
        # starting one stream never clears a pending stop on another.
        def _on_esc():
            self._stop_requested = True

        viz._LiveWindow.add_stop_listener(_on_esc)
        pending = None  # (stats, depth, copy event, dispatch time)
        frame_start = time.time()
        # Before any frame completes there is nothing to measure; the
        # first frame's overlay shows its latency-derived rate (the
        # reference showed target_fps -- SURVEY section 5 quirk, fixed).
        measured_fps = 0.0
        failures = 0  # consecutive -- reset on every successful frame
        index = 0

        def frame_failed():
            nonlocal failures
            self.metrics.record_failure()
            failures += 1
            if failures >= self.MAX_CONSECUTIVE_FAILURES:
                raise RuntimeError(
                    f"{failures} consecutive frame failures; stream "
                    "appears broken (see metrics.frames_failed)."
                )

        def sync(item):
            nonlocal index
            stats, depth, done, t0 = item
            # The only wait of a frame: its read-back copies' event (a
            # kernel fault of the frame surfaces here too).
            if done is not None:
                done.synchronize()
            depth_m = None if depth is None else depth.numpy()
            self.metrics.update(frame_metrics_from_stats(
                stats, depth_m, frame_index=index,
                latency_ms=(time.time() - t0) * 1000.0,
            ))
            self.metrics.record_bytes(bytes_out=(
                16 + (0 if depth_m is None else depth_m.nbytes)))
            index += 1
            return depth_m

        def stop_now():
            return self._stop_requested

        try:
            for left, right in self._frames():
                # Per-frame error isolation: a dispatch or readback failure
                # skips that frame (counted in metrics) instead of killing
                # the stream (SURVEY.md section 5 failure-detection gap).
                try:
                    if stager is not None:
                        left, right = stager.adopt(*stager.stage((left, right)))
                    # The float16 cast runs on the device, in _readback:
                    # it halves the depth map's D2H bytes.
                    dispatched = self._readback(*self.core.estimate_depth_async(left, right))
                    self.metrics.record_bytes(
                        bytes_in=(getattr(left, "nbytes", 0)
                                  + getattr(right, "nbytes", 0)))
                except Exception:  # noqa: BLE001 -- isolate the frame
                    frame_failed()
                    continue
                if pending is not None:
                    try:
                        depth_m = sync(pending)
                    except Exception:  # noqa: BLE001
                        frame_failed()
                        pending = (*dispatched, time.time())
                        # Keep per-frame timing honest across isolated
                        # failures: the failed frame's wait must not be
                        # charged to the next successful frame.
                        frame_start = time.time()
                        continue
                    failures = 0
                    if index == 1:
                        # First completed frame: no inter-frame interval
                        # exists yet, so show its latency-derived rate.
                        measured_fps = self.metrics.throughput_fps
                    yield depth_m
                    self._emit(depth_m, measured_fps)
                    if stop_now():
                        return
                    if self._frame_interval > 0:
                        sleep_t = (self._frame_interval
                                   - (time.time() - frame_start))
                        if sleep_t > 0:
                            time.sleep(sleep_t)
                    now = time.time()
                    dt = now - frame_start
                    measured_fps = 1.0 / dt if dt > 0 else measured_fps
                    frame_start = now
                pending = (*dispatched, time.time())
                if stop_now():
                    break

            if pending is not None and not stop_now():
                try:
                    depth_m = sync(pending)
                except Exception:  # noqa: BLE001
                    self.metrics.record_failure()
                    return
                if index == 1:
                    measured_fps = self.metrics.throughput_fps
                yield depth_m
                self._emit(depth_m, measured_fps)
        finally:
            viz._LiveWindow.remove_stop_listener(_on_esc)


class MonocularDepthEstimator:
    """Monocular depth through the ViT+DPT net (Depth Anything V2).

    Parity: depthlib/MonocularDepthEstimator.py:8-100 -- model load at
    init, a warm-up forward on a 224x224 dummy, per-image inference with
    the output inverted (max - depth) for display
    (MonocularDepthEstimator.py:73). model_path is a size preset
    ('small'/'base'/'large', random weights), a checkpoint directory of
    MonoDepthModel.save() or an HF Depth-Anything snapshot. device
    defaults to "cuda" and raises RuntimeError when no card is usable.
    """

    def __init__(self, model_path, device="cuda", downscale_factor: float = 1.0):
        if not model_path:
            raise ValueError("Model path must be provided.")
        self.model_path = model_path
        self.device = _resolve_device(device)
        self.downscale_factor = downscale_factor
        self.model = None
        self.depth_map = None
        self.load_model()

    def load_model(self):
        from .models.mono import MonoDepthModel

        print(f"Loading model from {self.model_path}")
        self.model = MonoDepthModel.load(self.model_path, device=self.device)
        self.warmup()

    def warmup(self):
        if self.model is None:
            raise RuntimeError("Model is not loaded properly.")
        print("Warming up the model")
        self.model.predict(np.full((224, 224, 3), 255, dtype=np.uint8))

    def estimate_depth(self, image_path) -> np.ndarray:
        if self.model is None:
            raise RuntimeError("Model is not loaded properly.")
        print("Estimating depth for the provided image")
        return self._estimate_image(load_image(image_path))

    def _estimate_image(self, image: np.ndarray) -> np.ndarray:
        """Everything estimate_depth does after decoding the file: area
        downscale, predict, then invert for display (ref :73)."""
        if self.downscale_factor != 1.0:
            image = _area_downscale_np(image, self.downscale_factor)
        depth = self.model.predict(image)
        depth = np.max(depth) - depth
        self.depth_map = depth
        return depth

    def visualize_depth(self):
        if self.depth_map is None:
            raise RuntimeError(
                "Depth map is not available. Please run estimate_depth first."
            )
        print("Visualizing depth map")
        viz.visualize_depth(self.depth_map, show_meter=False)
