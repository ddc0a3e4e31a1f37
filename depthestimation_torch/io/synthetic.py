"""Synthetic stereo scenes with exact ground-truth disparity (a numpy
copy of depthestimation_tpu/io/synthetic.py; the port imports nothing of
the JAX package).

The reference ships a Middlebury calib.txt but its stereo PNGs are
stripped from the snapshot (reference .MISSING_LARGE_BLOBS), so a fresh
checkout cannot run any demo. This module synthesizes a textured
fronto-parallel-plane scene viewed from two rectified cameras, giving the
examples (and tests/benchmarks) a self-contained input with a known
disparity field: layered planes are painted far-to-near in both views, the
right view sampling each plane's texture shifted by its disparity
d = f * B / Z, which also makes occlusions geometrically consistent.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "synthesize_stereo_pair",
    "synthetic_stream",
    "write_demo_assets",
    "calib_text",
    "DEMO_CALIB",
]

# Calibration of the synthetic rig (Middlebury calib.txt fields).
DEMO_CALIB = {
    "focal_px": 600.0,
    "baseline_mm": 120.0,
    "doffs": 0.0,
    "width": 640,
    "height": 480,
    "ndisp": 64,
}


def _texture(h: int, w: int, rng: np.random.Generator, scale: float) -> np.ndarray:
    """Band-limited random texture with strong local contrast (SAD-friendly)."""
    noise = rng.standard_normal((h, w))
    # Two box-blur passes = triangular kernel; keeps mid-frequency detail.
    k = max(int(scale), 1)
    kern = np.ones(k) / k
    for axis in (0, 1):
        noise = np.apply_along_axis(
            lambda m: np.convolve(m, kern, mode="same"), axis, noise
        )
    lo, hi = noise.min(), noise.max()
    return (noise - lo) / (hi - lo + 1e-9)


def _planes(rng: np.random.Generator, w: int, h: int, ndisp: int):
    """(disparity, x0, y0, bw, bh) boxes, far to near, plus background."""
    boxes = [
        (0.15 * ndisp, int(0.08 * w), int(0.15 * h), int(0.30 * w), int(0.45 * h)),
        (0.45 * ndisp, int(0.45 * w), int(0.30 * h), int(0.28 * w), int(0.40 * h)),
        (0.80 * ndisp, int(0.22 * w), int(0.55 * h), int(0.34 * w), int(0.30 * h)),
    ]
    return boxes


def synthesize_stereo_pair(
    width: int = 640,
    height: int = 480,
    ndisp: int = 64,
    seed: int = 0,
    shift: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (left_rgb, right_rgb, gt_disparity) — uint8 images (H, W, 3)
    and the float32 left-view disparity field.

    shift: sub-plane lateral offset in pixels applied to every surface
    (used by synthetic_stream to fake camera motion between frames).
    """
    rng = np.random.default_rng(seed)
    bg_disp = 0.06 * ndisp

    def paint(view_shift: float):
        img = np.empty((height, width), np.float32)
        disp = np.empty((height, width), np.float32)
        # Background plane.
        tex = _texture(height, width + ndisp + 8, rng_bg, 3)
        xs = (np.arange(width) + view_shift * bg_disp + shift).astype(int) % tex.shape[1]
        img[:] = tex[:, xs]
        disp[:] = bg_disp
        # Near planes, far to near.
        for (d, x0, y0, bw, bh), tex_p in zip(boxes, box_tex):
            # In the right view (view_shift=1) the box region slides left
            # by its disparity; the texture rides with the surface.
            xr0 = int(round(x0 - view_shift * d + shift))
            x_lo, x_hi = max(xr0, 0), min(xr0 + bw, width)
            if x_lo >= x_hi:
                continue
            tx = np.arange(x_lo - xr0, x_hi - xr0)
            img[y0 : y0 + bh, x_lo:x_hi] = tex_p[:, tx]
            disp[y0 : y0 + bh, x_lo:x_hi] = d
        return img, disp

    rng_bg = np.random.default_rng(seed + 1)
    boxes = _planes(rng, width, height, ndisp)
    box_tex = []
    for d, x0, y0, bw, bh in boxes:
        rng_box = np.random.default_rng(seed + 17 + int(d))
        box_tex.append(_texture(bh, bw, rng_box, 2))

    rng_bg = np.random.default_rng(seed + 1)
    left, gt = paint(0.0)
    rng_bg = np.random.default_rng(seed + 1)
    right, _ = paint(1.0)

    def to_rgb(g):
        u = (np.clip(g, 0, 1) * 255).astype(np.uint8)
        return np.stack([u] * 3, axis=-1)

    return to_rgb(left), to_rgb(right), gt.astype(np.float32)


def synthetic_stream(
    n_frames: int = 30,
    width: int = 640,
    height: int = 480,
    ndisp: int = 64,
    seed: int = 0,
) -> Tuple[Iterator[np.ndarray], Iterator[np.ndarray]]:
    """Two synchronized frame iterables (left, right) with lateral motion —
    a drop-in for the video facade's iterable sources."""
    lefts, rights = [], []
    for i in range(n_frames):
        l, r, _ = synthesize_stereo_pair(width, height, ndisp, seed=seed,
                                         shift=0.8 * i)
        lefts.append(l)
        rights.append(r)
    return lefts, rights


def calib_text(c=None) -> str:
    """A Middlebury-format calib.txt for a rig of DEMO_CALIB's keys
    (default DEMO_CALIB): cam0 and cam1 share f and cy, cx1 = cx0 + doffs."""
    c = c or DEMO_CALIB
    f, w, h = c["focal_px"], c["width"], c["height"]
    cx0, cx1, cy = 0.42 * w, 0.42 * w + c["doffs"], 0.5 * h
    return (
        f"cam0=[{f} 0 {cx0:.3f}; 0 {f} {cy:.3f}; 0 0 1]\n"
        f"cam1=[{f} 0 {cx1:.3f}; 0 {f} {cy:.3f}; 0 0 1]\n"
        f"doffs={c['doffs']}\n"
        f"baseline={c['baseline_mm']}\n"
        f"width={w}\n"
        f"height={h}\n"
        f"ndisp={c['ndisp']}\n"
        "isint=0\n"
        "vmin=4\n"
        f"vmax={c['ndisp'] - 4}\n"
    )


def write_demo_assets(root: str = "assets", seed: int = 0,
                      overwrite: bool = False) -> dict:
    """Write im0.png / im1.png / gt_disp.npy under root/stereo_pairs and a
    matching Middlebury-format root/calib.txt. Returns the paths. The PNG
    files are written by io/png.py, so no imaging package is needed."""
    from .png import write_png

    pair_dir = os.path.join(root, "stereo_pairs")
    os.makedirs(pair_dir, exist_ok=True)
    paths = {
        "left": os.path.join(pair_dir, "im0.png"),
        "right": os.path.join(pair_dir, "im1.png"),
        "gt": os.path.join(pair_dir, "gt_disp.npy"),
        "calib": os.path.join(root, "calib.txt"),
    }
    if not overwrite and all(os.path.exists(p) for p in paths.values()):
        return paths
    c = DEMO_CALIB
    left, right, gt = synthesize_stereo_pair(
        c["width"], c["height"], c["ndisp"], seed=seed
    )
    write_png(paths["left"], left)
    write_png(paths["right"], right)
    np.save(paths["gt"], gt)
    with open(paths["calib"], "w") as fh:
        fh.write(calib_text())
    return paths
