"""Host-side stereo input pipeline feeding the card (counterpart of
depthestimation_tpu/io/threaded.py).

The capability this covers in the reference is a single producer thread
with a 2-deep queue (depthlib/threaded_stereo.py). Here the design centers
on keeping the card busy instead: a decode stage turns two synchronized
sources into frame pairs, an optional transfer stage stages each pair into
the card's memory while the previous pair is still being computed, and a
bounded prefetch buffer with live/offline policies decides what happens
under backpressure:

- live policy (drop_frames=True): a camera must see fresh frames, so when
  compute falls behind, the oldest queued pair is evicted.
- offline policy (files): the producer blocks, every frame is processed.

Staging (device="cuda..."): the producer copies each host frame into a
pinned buffer of a small ring and from there to the card with a
non-blocking copy on a side stream of its own, and records an event that
travels with the pair. A pinned buffer is refilled only after the event of
the copy that read it has completed. The consumer (read / iteration, on
the caller's thread) makes its current stream wait on that event and
marks the pair's tensors as used on that stream (record_stream), so the
caching allocator never hands their memory to a later copy while the
compute stream still reads them. An evicted pair is freed on the copy
stream, where any later copy is ordered after the one that filled it.

The consumer side is an iterator (``for left, right in pipe:``); ``read``
/ ``start`` / ``stop`` are kept so the pipeline can slot where the
reference's capture object was.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..pipeline import _resolve_device
from .input import _area_downscale_np, open_capture

__all__ = ["StereoInputPipeline", "ThreadedStereoCapture", "PairStager"]

_END = object()  # stream-end sentinel so consumers never rely on timeouts


class PairStager:
    """Copies host frame pairs to a CUDA device on a side stream, through
    a ring of pinned host buffers.

    stage() may run on any thread; adopt() runs on the thread that
    computes on the pair, with the stream it computes on current.
    """

    RING = 2  # pinned slots; a slot is refilled after its copy completed

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._ring = [None] * self.RING  # (pinned buffers, copy event)
        self._next = 0

    def stage(self, frames):
        """Host frames -> (tensors on the card, event of their copy)."""
        frames = [torch.from_numpy(np.ascontiguousarray(f)) for f in frames]
        slot = self._ring[self._next]
        bufs = None
        if slot is not None:
            bufs, done = slot
            done.synchronize()
            if [(b.shape, b.dtype) for b in bufs] != [(f.shape, f.dtype) for f in frames]:
                bufs = None
        if bufs is None:
            bufs = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
                    for f in frames]
        for b, f in zip(bufs, frames):
            b.copy_(f)
        with torch.cuda.stream(self.stream):
            staged = tuple(b.to(self.device, non_blocking=True) for b in bufs)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._ring[self._next] = (bufs, done)
        self._next = (self._next + 1) % self.RING
        return staged, done

    def adopt(self, staged, done):
        """Order the current stream after the pair's copy and tell the
        allocator that stream uses the pair; returns the tensors."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        for t in staged:
            t.record_stream(cur)
        return staged


class StereoInputPipeline:
    """Two-stage (decode -> [transfer] -> prefetch) stereo input pipeline.

    Args:
        left_source / right_source: anything io.input.open_capture accepts
            (device index, path, RTSP url) or an iterable of frames.
        downscale_factor: host-side area downscale applied at decode.
        prefetch: buffer depth (2 = classic double buffering).
        drop_frames: live policy — evict the oldest pair on overflow.
        device: None yields host numpy pairs; a CUDA device stages each
            pair into that card's memory on the producer thread, so the
            H2D copy overlaps compute (RuntimeError without a card).
    """

    def __init__(
        self,
        left_source,
        right_source,
        downscale_factor: float = 1.0,
        prefetch: int = 2,
        drop_frames: bool = False,
        device=None,
    ):
        self._sources = (left_source, right_source)
        self._downscale = downscale_factor
        self._drop = drop_frames
        self._stager = None
        if device is not None and _resolve_device(device).type == "cuda":
            self._stager = PairStager(device)
        self._buf: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._quit = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._caps = None
        self.frames_dropped = 0
        self.frames_decoded = 0
        self.frames_failed = 0  # per-frame error isolation (SURVEY.md 5)

    # Consecutive decode failures tolerated before the stream is declared
    # dead (guards against spinning forever on a permanently broken source).
    MAX_CONSECUTIVE_FAILURES = 8

    # -- producer ---------------------------------------------------------
    def _decode_pair(self):
        cl, cr = self._caps
        ok_l, fl = cl.read()
        ok_r, fr = cr.read()
        if not (ok_l and ok_r) or fl is None or fr is None:
            return None
        if self._downscale != 1.0:
            fl = _area_downscale_np(fl, self._downscale)
            fr = _area_downscale_np(fr, self._downscale)
        return fl, fr

    def _produce(self):
        consecutive_failures = 0
        try:
            while not self._quit.is_set():
                # Per-frame error isolation: a corrupt frame (decode raise
                # or failed H2D) is counted and skipped; only a clean
                # end-of-stream or a run of failures ends the stream. The
                # reference kills the whole stream on any failure
                # (threaded_stereo.py:58-60).
                try:
                    pair = self._decode_pair()
                    if pair is None:
                        break
                    item = (pair if self._stager is None
                            else self._stager.stage(pair))
                except Exception:  # noqa: BLE001 — isolate the frame
                    self.frames_failed += 1
                    consecutive_failures += 1
                    if consecutive_failures >= self.MAX_CONSECUTIVE_FAILURES:
                        break
                    continue
                consecutive_failures = 0
                self.frames_decoded += 1
                if self._drop:
                    while True:
                        try:
                            self._buf.put_nowait(item)
                            break
                        except queue.Full:
                            try:
                                self._buf.get_nowait()
                                self.frames_dropped += 1
                            except queue.Empty:
                                pass
                else:
                    while not self._quit.is_set():
                        try:
                            self._buf.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        finally:
            # Always deliver the end marker, but never at the cost of a real
            # frame under the offline (no-drop) policy — block until the
            # consumer drains, bailing out only once stop() was requested.
            while True:
                if self._quit.is_set():
                    try:
                        self._buf.put_nowait(_END)
                    except queue.Full:
                        pass
                    break
                try:
                    self._buf.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    if self._drop:
                        try:
                            self._buf.get_nowait()
                            self.frames_dropped += 1
                        except queue.Empty:
                            pass

    # -- lifecycle / consumer ---------------------------------------------
    def start(self) -> "StereoInputPipeline":
        self._caps = (open_capture(self._sources[0]),
                      open_capture(self._sources[1]))
        self._quit.clear()
        self._worker = threading.Thread(
            target=self._produce, name="stereo-input", daemon=True
        )
        self._worker.start()
        return self

    def read(self, timeout: float = 5.0):
        """Next frame pair, or None at stream end. A staged pair comes
        back as tensors on the card that the caller's current stream may
        read."""
        try:
            item = self._buf.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is _END:
            return None
        return item if self._stager is None else self._stager.adopt(*item)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            pair = self.read()
            if pair is None:
                return
            yield pair

    def stop(self):
        self._quit.set()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
            self._worker = None
        if self._caps is not None:
            for c in self._caps:
                c.release()
            self._caps = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ThreadedStereoCapture(StereoInputPipeline):
    """Name kept for users coming from the reference API
    (depthlib/threaded_stereo.py); same object as StereoInputPipeline with
    the reference's constructor argument names."""

    def __init__(self, left_source, right_source, downscale_factor=1.0,
                 buffer_size: int = 2, drop_frames: bool = True,
                 device=None):
        super().__init__(
            left_source, right_source, downscale_factor=downscale_factor,
            prefetch=buffer_size, drop_frames=drop_frames, device=device,
        )
