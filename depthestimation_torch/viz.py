"""Host-side visualization (matplotlib static figures + GUI-free live views).

A numpy copy of depthestimation_tpu/viz.py: the port imports nothing of
the JAX package. matplotlib is imported only inside the functions that
draw, so the streaming facade runs where it is not installed.

Capability parity with depthlib/visualizations.py: the same six entry
points and the same display *math* users rely on — 1-99 percentile
disparity auto-range (visualizations.py:41-45), invalid-aware depth stats
(visualizations.py:85-106), and the live view's 50 m cap with gamma-0.5
near-range emphasis on a turbo map (visualizations.py:184-234). The
implementation is organized around shared panel helpers, and live views
render to plain RGB arrays so they work headless (a matplotlib window is
attached only when an interactive backend exists).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "visualize_stereo_pair",
    "visualize_disparity",
    "visualize_depth",
    "visualize_disparity_and_depth",
    "render_depth_live",
    "render_depth_live_gray",
    "visualize_depth_live",
    "visualize_depth_live_gray",
]

DISPLAY_MAX_DEPTH_M = 50.0  # live-view range cap (visualizations.py:193,221)


# ---------------------------------------------------------------------------
# Shared panel helpers.
# ---------------------------------------------------------------------------


def _finite_positive(a: np.ndarray) -> np.ndarray:
    return np.isfinite(a) & (a > 0)


def _disp_range(disp: np.ndarray) -> Tuple[float, float]:
    """1-99 percentile range over valid pixels; degenerate-safe."""
    ok = disp > 0
    if not ok.any():
        return 0.0, float(disp.max()) if disp.size else 1.0
    return float(np.percentile(disp[ok], 1)), float(np.percentile(disp[ok], 99))


def _disparity_panel(ax, disp, cmap="jet", vmin=None, vmax=None,
                     label="Pixels"):
    import matplotlib.pyplot as plt

    lo, hi = _disp_range(disp)
    vmin = lo if vmin is None else vmin
    vmax = hi if vmax is None else vmax
    im = ax.imshow(disp, cmap=cmap, vmin=vmin, vmax=vmax)
    ax.axis("off")
    plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04, label=label)
    return vmin, vmax


def _depth_panel(ax, depth, cmap="turbo_r", cap_pct=99, colorbar=True):
    """Render depth with invalid pixels pushed to the far end; returns the
    (min, cap, invalid%) stats used for the title, or None if nothing is
    displayable."""
    import matplotlib.pyplot as plt

    ok = _finite_positive(depth)
    if not ok.any():
        return None
    cap = float(np.percentile(depth[ok], cap_pct))
    shown = np.where(ok, np.clip(depth, 0, cap), cap)
    im = ax.imshow(shown, cmap=cmap, vmin=0, vmax=cap)
    ax.axis("off")
    if colorbar:
        plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04, label="Meters")
    return float(depth[ok].min()), cap, float(100.0 * (~ok).mean())


# ---------------------------------------------------------------------------
# Static figures (API parity with the reference's matplotlib plots).
# ---------------------------------------------------------------------------


def visualize_stereo_pair(left_img_rgb, right_img_rgb,
                          title_left="Left Image",
                          title_right="Right Image"):
    """Side-by-side input pair."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, img, title in ((axes[0], left_img_rgb, title_left),
                           (axes[1], right_img_rgb, title_right)):
        ax.imshow(img, cmap="gray" if np.ndim(img) == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    plt.tight_layout()
    plt.show()


def visualize_disparity(disparity_px, title="Disparity Map", cmap="jet",
                        vmin=None, vmax=None):
    import matplotlib.pyplot as plt

    disp = np.asarray(disparity_px)
    fig, ax = plt.subplots(figsize=(10, 6))
    lo, hi = _disparity_panel(ax, disp, cmap, vmin, vmax,
                              label="Disparity (pixels)")
    ax.set_title(f"{title}\n(Range: {lo:.1f} - {hi:.1f} pixels)")
    plt.tight_layout()
    plt.show()


def visualize_depth(depth_m, title="Depth Map", cmap="turbo_r",
                    max_depth=None, show_invalid=True, show_meter=True):
    import matplotlib.pyplot as plt

    if depth_m is None:
        print("[viz] no depth map to show (got None)")
        return
    depth = np.asarray(depth_m)
    ok = _finite_positive(depth)
    if not ok.any():
        print("[viz] depth map has no finite positive values; skipping plot")
        return
    cap = float(np.percentile(depth[ok], 99)) if max_depth is None else max_depth
    shown = np.where(ok, np.clip(depth, 0, cap), cap if show_invalid else 0)

    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(shown, cmap=cmap, vmin=0, vmax=cap)
    ax.set_title(
        f"{title}\n(Range: {depth[ok].min():.2f} - {cap:.2f}m, "
        f"{100.0 * (~ok).mean():.1f}% invalid/far)"
    )
    ax.axis("off")
    if show_meter:
        cbar = plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        cbar.set_label("Depth (meters)", rotation=270, labelpad=15)
    plt.tight_layout()
    plt.show()


def visualize_disparity_and_depth(disparity_px, depth_m, left_img=None):
    """Combined figure: optional reference image row + disparity/depth row."""
    import matplotlib.pyplot as plt

    disp = np.asarray(disparity_px)
    if left_img is not None:
        fig, axes = plt.subplots(2, 2, figsize=(14, 10))
        axes = axes.flatten()
        axes[0].imshow(left_img, cmap="gray" if np.ndim(left_img) == 2 else None)
        axes[0].set_title("Reference Image (Left)")
        axes[0].axis("off")
        axes[1].axis("off")
        disp_ax, depth_ax = axes[2], axes[3]
    else:
        fig, (disp_ax, depth_ax) = plt.subplots(1, 2, figsize=(14, 5))

    lo, hi = _disparity_panel(disp_ax, disp)
    disp_ax.set_title(f"Disparity Map\n({lo:.1f} - {hi:.1f} px)")

    stats = None
    if depth_m is not None:
        stats = _depth_panel(depth_ax, np.asarray(depth_m), cap_pct=95)
    if stats is not None:
        dmin, cap, bad_pct = stats
        depth_ax.set_title(
            f"Depth Map\n({dmin:.2f} - {cap:.2f}m, {bad_pct:.1f}% invalid)"
        )
    else:
        msg = ("no valid depth values" if depth_m is not None
               else "depth map not available")
        depth_ax.text(0.5, 0.5, msg, ha="center", va="center",
                      transform=depth_ax.transAxes)
        depth_ax.axis("off")
    plt.tight_layout()
    plt.show()


# ---------------------------------------------------------------------------
# Live views: pure array rendering; window attach is optional.
# ---------------------------------------------------------------------------


def _live_normalize(depth_m) -> Optional[np.ndarray]:
    """Depth -> near-is-1 normalized field under the 50 m display cap;
    None when the frame has nothing valid."""
    depth = np.asarray(depth_m)
    ok = _finite_positive(depth)
    if not ok.any():
        return None
    capped = np.where(ok, np.clip(depth, 0, DISPLAY_MAX_DEPTH_M),
                      DISPLAY_MAX_DEPTH_M)
    return 1.0 - capped / DISPLAY_MAX_DEPTH_M


def _banner(frame: np.ndarray) -> np.ndarray:
    # Two bright rows mark live frames (GUI-free stand-in for the
    # reference's cv2.putText overlay; the window title carries the FPS).
    if frame.shape[0] >= 4:
        frame = frame.copy()
        frame[:2] = 255
    return frame


def render_depth_live(depth_m, fps: float) -> np.ndarray:
    """RGB uint8 live view: turbo colormap, nearer = hotter, gamma-0.5
    emphasis of the near range."""
    near = _live_normalize(depth_m)
    if near is None:
        return np.zeros((*np.shape(depth_m), 3), dtype=np.uint8)
    import matplotlib

    # matplotlib.colormaps replaced cm.get_cmap (removed in >= 3.9).
    lut = (matplotlib.colormaps["turbo"](np.linspace(0, 1, 256))[:, :3] * 255
           ).astype(np.uint8)
    # gamma on the *far* ratio, then invert so near is hot.
    idx = 255 - (np.sqrt(1.0 - near) * 255).astype(np.uint8)
    return _banner(lut[idx])


def render_depth_live_gray(depth_m, fps: float) -> np.ndarray:
    """Grayscale live view: nearer = brighter, linear."""
    near = _live_normalize(depth_m)
    if near is None:
        return np.zeros((*np.shape(depth_m), 3), dtype=np.uint8)
    g = (near * 255).astype(np.uint8)
    return _banner(np.repeat(g[..., None], 3, axis=-1))


class _LiveWindow:
    """Lazily-created interactive window; inert on headless backends.

    ESC (or closing the window) sets stop_requested, the reference's
    cv2.waitKey ESC-exit (StereoDepthEstimatorVideo.py:111-112); the
    streaming facade polls it between frames."""

    _fig = None
    _im = None
    stop_requested = False
    _listeners = ()  # per-stream stop callbacks (api.py registers one per
    # active stream, so one stream's start never clears another's ESC)

    @classmethod
    def reset(cls):
        cls.stop_requested = False

    @classmethod
    def add_stop_listener(cls, cb):
        cls._listeners = (*cls._listeners, cb)

    @classmethod
    def remove_stop_listener(cls, cb):
        cls._listeners = tuple(c for c in cls._listeners if c is not cb)

    @classmethod
    def _signal_stop(cls):
        cls.stop_requested = True
        for cb in cls._listeners:
            cb()

    @classmethod
    def _on_key(cls, event):
        if event.key == "escape":
            cls._signal_stop()

    @classmethod
    def _on_close(cls, event):
        cls._signal_stop()
        cls._fig = None
        cls._im = None

    @classmethod
    def show(cls, frame: np.ndarray, fps: float):
        import matplotlib

        if matplotlib.get_backend().lower() == "agg":
            return  # headless: callers still get the rendered frame
        import matplotlib.pyplot as plt

        title = f"FPS: {fps:.1f} | cap {DISPLAY_MAX_DEPTH_M:.0f} m | ESC quits"
        if cls._fig is None:
            plt.ion()
            cls._fig, ax = plt.subplots(num="Depth (live)")
            cls._im = ax.imshow(frame)
            ax.axis("off")
            cls._fig.canvas.mpl_connect("key_press_event", cls._on_key)
            cls._fig.canvas.mpl_connect("close_event", cls._on_close)
        cls._im.set_data(frame)
        cls._fig.axes[0].set_title(title)
        cls._fig.canvas.draw_idle()
        cls._fig.canvas.flush_events()


def visualize_depth_live(depth_m, fps):
    """Live depth display; headless-safe. Returns the rendered frame."""
    frame = render_depth_live(depth_m, fps)
    _LiveWindow.show(frame, fps)
    return frame


def visualize_depth_live_gray(depth_m, fps):
    frame = render_depth_live_gray(depth_m, fps)
    _LiveWindow.show(frame, fps)
    return frame
