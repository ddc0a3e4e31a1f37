"""Host-side input: image loading and synchronized stereo streams
(counterpart of depthestimation_tpu/io/input.py, reference
depthlib/input.py). Decoding stays on the host. PNG files are read by
io/png.py; PIL or imageio is imported only for another image format, a
PNG that io/png.py does not read, a video file or a camera, so common
PNG files and streams of frame iterables need neither.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple, Union

import numpy as np
import torch

__all__ = ["load_image", "load_stereo_pair", "open_capture", "stereo_stream"]


def _area_downscale_np(img: np.ndarray, factor: float) -> np.ndarray:
    """Host-side area downscale matching input.py:39-43 size math."""
    if factor == 1.0:
        return img
    h, w = img.shape[:2]
    nh, nw = int(h * factor), int(w * factor)
    try:
        from PIL import Image

        pil = Image.fromarray(img)
        return np.asarray(pil.resize((nw, nh), Image.Resampling.BOX))
    except ImportError:
        # Without PIL: the JAX package's area resize (linear, antialiased)
        # over the whole image, for any factor.
        from ..ops import color

        return color.resize_area(torch.from_numpy(np.ascontiguousarray(img)),
                                 (nh, nw)).numpy()


def load_image(path) -> np.ndarray:
    """Load an image file as RGB uint8 (H, W, 3).

    A PNG file is decoded by io/png.py (zlib and numpy, no imaging
    package), on every machine alike, into what PIL's convert("RGB")
    gives. What io/png.py does not read (other formats, an interlaced or
    16-bit PNG, a file object) goes through PIL, else imageio; without
    either, the PNG reader's ValueError or an ImportError is raised."""
    from . import png

    refused = None
    if isinstance(path, (str, os.PathLike)) and png.is_png(path):
        try:
            return png.to_rgb(*png.read_png(path))
        except ValueError as e:
            refused = e
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    try:
        import imageio.v3 as iio
    except ImportError:
        if refused is not None:
            raise refused from None
        raise ImportError(
            f"{path}: only PNG files that io/png.py reads are read without PIL "
            "or imageio; install Pillow or imageio for other images") from None
    arr = iio.imread(path)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3]


def load_stereo_pair(left_image_path, right_image_path, downscale_factor=1.0):
    """Load a stereo pair as RGB, optionally downscaled.

    FileNotFoundError message parity with input.py:31-32.
    """
    try:
        left = load_image(left_image_path)
        right = load_image(right_image_path)
    except (FileNotFoundError, OSError):
        raise FileNotFoundError("One or both image paths are invalid.")
    left = _area_downscale_np(left, downscale_factor)
    right = _area_downscale_np(right, downscale_factor)
    return left, right


class _FrameCapture:
    """Minimal VideoCapture equivalent over imageio-ffmpeg (files/URLs) or a
    user-provided frame iterable (cameras/synthetic sources for tests)."""

    def __init__(self, source: Union[int, str, Iterable]):
        self._iter = None
        self._reader = None
        if hasattr(source, "__iter__") and not isinstance(source, (str, bytes)):
            self._iter = iter(source)
        else:
            import imageio.v2 as iio

            src = f"<video{source}>" if isinstance(source, int) else source
            try:
                self._reader = iio.get_reader(src)
            except Exception as e:
                raise RuntimeError(f"Unable to open video source: {source}") from e
            self._iter = iter(self._reader)

    def read(self):
        try:
            frame = next(self._iter)
            return True, np.asarray(frame)
        except StopIteration:
            return False, None

    def release(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def isOpened(self):
        return self._iter is not None


def open_capture(source) -> _FrameCapture:
    """Open a capture from camera index, file path, URL or frame iterable
    (open_capture parity, input.py:50-55)."""
    cap = _FrameCapture(source)
    if not cap.isOpened():
        raise RuntimeError(f"Unable to open video source: {source}")
    return cap


def _read_frame(cap: _FrameCapture, downscale_factor: float) -> np.ndarray:
    ok, frame = cap.read()
    if not ok or frame is None:
        raise RuntimeError("Failed to read frame from video source")
    return _area_downscale_np(frame, downscale_factor)


def stereo_stream(
    left_source, right_source, downscale_factor: float = 1.0
) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """Yield synchronized frame pairs; releases captures in finally
    (stereo_stream parity, input.py:71-95)."""
    if downscale_factor <= 0 or downscale_factor > 1.0:
        raise ValueError("downscale_factor must be between 0 and 1.")
    cap_l = open_capture(left_source)
    cap_r = open_capture(right_source)
    try:
        while True:
            left = _read_frame(cap_l, downscale_factor)
            right = _read_frame(cap_r, downscale_factor)
            yield left, right
    except RuntimeError:
        return
    finally:
        cap_l.release()
        cap_r.release()
