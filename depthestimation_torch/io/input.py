"""Host-side image loading (counterpart of depthestimation_tpu/io/input.py,
reference depthlib/input.py). Decoding stays on the host; PIL (or imageio)
is imported only when an image is loaded. Video capture comes with the
streaming slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image", "load_stereo_pair"]


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
        # Without PIL: strided subsampling (integer factors only).
        sy, sx = max(h // nh, 1), max(w // nw, 1)
        return img[::sy, ::sx][:nh, :nw]


def load_image(path) -> np.ndarray:
    """Load an image file as RGB uint8 (H, W, 3)."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except ImportError:
        import imageio.v3 as iio

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
