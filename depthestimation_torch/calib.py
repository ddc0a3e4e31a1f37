"""Stereo rectification math, from scratch (host-side numpy).

A copy of depthestimation_tpu/calib.py (numpy only), kept separate so the
port never imports the JAX package; only RectificationCache adds to it:
beside the host maps of get_maps it keeps their float32 copies on the
devices the pipeline asks for (device_maps).

Replacement for cv2.stereoRectify + cv2.initUndistortRectifyMap
(reference rectify.py:63-73,209-227). Map construction is small dense
linear algebra executed once per calibration and cached (mirroring the
reference's single-entry RectificationCache, rectify.py:14-85); the per-
frame work is only the remap (ops/remap.py), which runs on the device.

Implements the Bouguet rectification algorithm with CALIB_ZERO_DISPARITY
and the alpha free-scaling parameter (the reference core always passes
alpha=1.0, stereo_core.py:150). Plumb distortion through an iterative
undistort (5-coefficient radial/tangential model, like cv2's default).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["stereo_rectify", "init_undistort_rectify_map", "RectificationCache",
           "rectification_maps"]


def _rodrigues_to_matrix(r: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _matrix_to_rodrigues(R: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return theta * v / (2 * np.sin(theta))


def _distort(pts: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply the 5-coefficient distortion model to normalized points
    (..., 2)."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def _undistort_points(pts: np.ndarray, K: np.ndarray, dist: np.ndarray,
                      iters: int = 5) -> np.ndarray:
    """Invert projection+distortion: pixel points (..., 2) -> normalized
    undistorted coordinates. Fixed-point iteration with cv2's exact
    default iteration count (undistortPoints runs TermCriteria MAX_ITER=5;
    verified bit-identical against the oracle in tests/test_rectification)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (pts[..., 0] - cx) / fx
    y = (pts[..., 1] - cy) / fy
    x0, y0 = x.copy(), y.copy()
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x, y], axis=-1)


def _get_rectangles(K, dist, R, P, image_size, n=9):
    """Inner (inscribed) and outer (bounding) rectangles of the source
    image mapped through rectification — used by the alpha free-scaling
    logic (OpenCV icvGetRectangles equivalent: an n x n grid over
    [0, w-1] x [0, h-1], inferred empirically against the cv2 oracle)."""
    w, h = image_size
    xs = np.linspace(0, w - 1, n)
    ys = np.linspace(0, h - 1, n)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    und = _undistort_points(pts, K, dist)
    ones = np.ones((*und.shape[:-1], 1))
    dirs = np.concatenate([und, ones], axis=-1) @ R.T
    proj = dirs[:, :2] / dirs[:, 2:3]
    fx, fy = P[0, 0], P[1, 1]
    cx, cy = P[0, 2], P[1, 2]
    # cv2 stores the mapped grid as float32 (CV_32FC2 in icvGetRectangles);
    # quantizing here keeps the free-scaling factor bit-compatible.
    px = (proj[:, 0] * fx + cx).astype(np.float32).reshape(n, n)
    py = (proj[:, 1] * fy + cy).astype(np.float32).reshape(n, n)
    outer = (px.min(), py.min(), px.max(), py.max())
    inner = (
        px[:, 0].max(), py[0, :].max(), px[:, -1].min(), py[-1, :].min(),
    )
    return inner, outer


def stereo_rectify(
    K1: np.ndarray,
    D1: np.ndarray,
    K2: np.ndarray,
    D2: np.ndarray,
    image_size: Tuple[int, int],
    R: np.ndarray,
    T: np.ndarray,
    alpha: float = -1.0,
    zero_disparity: bool = True,
):
    """Bouguet stereo rectification.

    Returns (R1, R2, P1, P2, Q). Matches cv2.stereoRectify semantics with
    flags=CALIB_ZERO_DISPARITY (rectify.py:63-73): both cameras rotated by
    half of the inter-camera rotation, then aligned so epipolar lines are
    horizontal; alpha blends between inner-crop (0) and full-outer (1)
    free scaling.
    """
    K1 = np.asarray(K1, float)
    K2 = np.asarray(K2, float)
    D1 = np.asarray(D1, float).ravel()
    D2 = np.asarray(D2, float).ravel()
    R = np.asarray(R, float)
    T = np.asarray(T, float).ravel()
    nx, ny = image_size

    # Split the rotation between the two cameras.
    om = _matrix_to_rodrigues(R) * -0.5
    r_r = _rodrigues_to_matrix(om)
    t = r_r @ T

    # Align the baseline with the dominant translation axis.
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 1e-15:
        ww *= np.arccos(np.clip(abs(c) / nt, -1, 1)) / nw
    wR = _rodrigues_to_matrix(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    # New focal length: the mean of the two fy's (cv2.stereoRectify's
    # current behavior — no pincushion shrink, verified vs the oracle).
    fc_new = 0.5 * (K1[1, 1] + K2[1, 1])

    # New principal points from the projected image corners. cv2 stores
    # the undistorted corners as float32 (CV_32FC2) before projecting;
    # quantizing keeps cc bit-compatible with the oracle.
    cc_new = []
    for K, D, Rk in ((K1, D1, R1), (K2, D2, R2)):
        corners = np.array(
            [[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], float
        )
        und = _undistort_points(corners, K, D).astype(np.float32).astype(float)
        dirs = np.concatenate([und, np.ones((4, 1))], axis=-1) @ Rk.T
        proj = dirs[:, :2] / dirs[:, 2:3]
        # ... and the projected corners too (same CV_32FC2 buffer).
        px = (proj * fc_new).astype(np.float32).astype(float)
        avg = px.mean(axis=0)
        cc_new.append(np.array([(nx - 1) / 2, (ny - 1) / 2]) - avg)

    if zero_disparity:
        cc = (cc_new[0] + cc_new[1]) * 0.5
        cc_new = [cc.copy(), cc.copy()]
    else:
        other = 1 - idx
        m = (cc_new[0][other] + cc_new[1][other]) * 0.5
        cc_new[0][other] = cc_new[1][other] = m

    def make_P(cc, tvec=None):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = cc
        P[2, 2] = 1.0
        if tvec is not None:
            P[idx, 3] = tvec[idx] * fc_new
        return P

    P1 = make_P(cc_new[0])
    P2 = make_P(cc_new[1], t)

    # Alpha free-scaling: cv2 scales ONLY the focal length around the
    # principal points (which stay fixed); s0 zooms in until the inner
    # rectangles fill [0, nx] x [0, ny] (alpha = 0), s1 zooms out until
    # the outer rectangles fit inside (alpha = 1).
    if alpha >= 0:
        alpha = min(alpha, 1.0)
        inner1, outer1 = _get_rectangles(K1, D1, R1, P1, image_size)
        inner2, outer2 = _get_rectangles(K2, D2, R2, P2, image_size)

        def s_for(rect, cc, mode):
            x0, y0, x1, y1 = rect
            cx, cy = cc
            cands = [cx / (cx - x0), cy / (cy - y0),
                     (nx - 1 - cx) / (x1 - cx), (ny - 1 - cy) / (y1 - cy)]
            return max(cands) if mode == "cover" else min(cands)

        s0 = max(
            s_for(inner1, cc_new[0], "cover"), s_for(inner2, cc_new[1], "cover")
        )
        s1 = min(
            s_for(outer1, cc_new[0], "fit"), s_for(outer2, cc_new[1], "fit")
        )
        s = s0 * (1 - alpha) + s1 * alpha
        fc_new *= s
        P1 = make_P(cc_new[0])
        P2 = make_P(cc_new[1], t)

    # Q reprojection matrix (disparity -> depth).
    Q = np.array(
        [
            [1, 0, 0, -cc_new[0][0]],
            [0, 1, 0, -cc_new[0][1]],
            [0, 0, 0, fc_new],
            [0, 0, -1.0 / t[idx], (cc_new[0][idx] - cc_new[1][idx]) / t[idx]],
        ]
    )
    return R1, R2, P1, P2, Q


def init_undistort_rectify_map(
    K: np.ndarray, D: np.ndarray, R: np.ndarray, P: np.ndarray,
    image_size: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Float32 sampling maps (map_x, map_y), cv2.initUndistortRectifyMap
    equivalent: for each rectified pixel, the source-image coordinates to
    sample."""
    K = np.asarray(K, float)
    D = np.asarray(D, float).ravel()
    P = np.asarray(P, float)
    nx, ny = image_size
    u, v = np.meshgrid(np.arange(nx, dtype=np.float64),
                       np.arange(ny, dtype=np.float64))
    fx_p, fy_p = P[0, 0], P[1, 1]
    cx_p, cy_p = P[0, 2], P[1, 2]
    x = (u - cx_p) / fx_p
    y = (v - cy_p) / fy_p
    pts = np.stack([x, y, np.ones_like(x)], axis=-1)
    Rinv = np.linalg.inv(np.asarray(R, float))
    dirs = pts @ Rinv.T
    xn = dirs[..., 0] / dirs[..., 2]
    yn = dirs[..., 1] / dirs[..., 2]
    dist_pts = _distort(np.stack([xn, yn], axis=-1), D)
    map_x = (K[0, 0] * dist_pts[..., 0] + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * dist_pts[..., 1] + K[1, 2]).astype(np.float32)
    return map_x, map_y


def rectification_maps(calib, baseline: float, alpha: float = 1.0) -> Dict[str, np.ndarray]:
    """Build the 4 sampling maps for a CalibConfig (+baseline).

    Reference analogue: RectificationCache.get_maps (rectify.py:42-80) —
    defaults T = [-baseline, 0, 0], R = I (rectify.py:205-206), alpha from
    the core is 1.0 (stereo_core.py:150).
    """
    size = (calib.image_width, calib.image_height)
    R1, R2, P1, P2, _ = stereo_rectify(
        calib.K_l(), calib.dist_l(), calib.K_r(), calib.dist_r(),
        size, calib.R(), calib.T(baseline), alpha=alpha, zero_disparity=True,
    )
    mx_l, my_l = init_undistort_rectify_map(calib.K_l(), calib.dist_l(), R1, P1, size)
    mx_r, my_r = init_undistort_rectify_map(calib.K_r(), calib.dist_r(), R2, P2, size)
    return {"map_x_l": mx_l, "map_y_l": my_l, "map_x_r": mx_r, "map_y_r": my_r}


class RectificationCache:
    """Single-entry cache of the maps keyed on the calibration content
    (reference rectify.py:14-85 keying idea: same params -> same maps
    object, identity-stable): built on the host once, and uploaded once
    to each device asked for."""

    def __init__(self):
        self.clear()

    def get_maps(self, calib, baseline: float, alpha: float = 1.0) -> Dict[str, np.ndarray]:
        """The host maps of rectification_maps (keys map_x_l, map_y_l,
        map_x_r, map_y_r), the same dict for the same (calib, baseline,
        alpha); another key replaces the entry and its device copies."""
        key = (calib, float(baseline), float(alpha))
        if self._key != key or self._maps is None:
            self._maps = rectification_maps(calib, baseline, alpha)
            self._key = key
            self._device_maps = {}
        return self._maps

    def device_maps(self, calib, baseline: float, alpha: float, device):
        """(map_x, map_y): float32 tensors of shape (2, H, W) on device,
        left camera first, from get_maps's entry, keyed alongside it on
        the device."""
        device = torch.device(device)
        m = self.get_maps(calib, baseline, alpha)
        if device not in self._device_maps:
            self._device_maps[device] = tuple(
                torch.from_numpy(np.stack([m[f"map_{c}_l"], m[f"map_{c}_r"]])).to(device)
                for c in ("x", "y"))
        return self._device_maps[device]

    def clear(self):
        self._key = None
        self._maps: Optional[Dict[str, np.ndarray]] = None
        self._device_maps: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
