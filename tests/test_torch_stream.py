"""The PyTorch port's streaming facade, StereoDepthEstimatorVideo on
device="cpu", against depthestimation_tpu.StereoDepthEstimatorVideo on the
same frames, frame by frame: threaded and sequential input, temporal
smoothing, float16 depth, a calibrated rig, per-frame failure isolation,
stop() and the single-frame fps rule.

Each JAX facade is built once per module and reused, so each of its
configurations compiles once. Tolerances, with their reasons:
- the disparity stats (min, max and mean over valid pixels) are exact:
  the disparities are on the 1/16 grid and their sums are exact in
  float32 at these sizes. valid_fraction is within 1 float32 ulp: the
  port divides the count by N, XLA multiplies it by 1/N.
- depth rtol 1e-5: one float32 division each side (the temporal blend
  too); float16 depth within 1 float16 ulp of JAX's.
- the calibrated rig: the tolerances of tests/test_torch_rectify.py (the
  rectified images are fractional and the SAD window is summed in
  another order, so a few pixels pick another disparity): depth within
  rtol 1e-5 on >= 99 % of pixels.
"""

import numpy as np
import pytest

import depthestimation_tpu as det
import depthestimation_torch as dt
from depthestimation_torch.io.synthetic import synthetic_stream
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

H, W, D = 32, 96, 16
BASE = dict(num_disp=D, focal_length=500.0, baseline=0.1, speckle_window_size=0)
FRAMES = synthetic_stream(6, W, H, D, seed=0)


def rig(h=48, w=160):
    """configure_sgbm keys of the mild rig of tests/test_torch_rectify.py
    (a 0.25 degree roll, light radial distortion) at h x w."""
    fx = 1000.0 * w / 1920
    k = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    th = np.deg2rad(0.25)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]])
    dist = np.array([-0.01, 0.002, 0.0, 0.0, 0.0])
    return dict(num_disp=D, sgbm_mode="hh4", speckle_window_size=0,
                cam_matrix_L=k, cam_matrix_R=k, image_width=w, image_height=h,
                dist_coeff_L=dist, dist_coeff_R=dist, rotation=rot,
                focal_length=fx, baseline=0.12)


# name -> (facade constructor keywords, configure_sgbm keywords, frames)
CONFIGS = {
    "fast": (dict(fast_mode=True), BASE, FRAMES),
    "temporal": (dict(fast_mode=True, use_threading=False),
                 dict(BASE, temporal_alpha=0.5), FRAMES),
    "calibrated": (dict(fast_mode=True), rig(),
                   synthetic_stream(3, 160, 48, D, seed=5)),
}


@pytest.fixture(scope="module")
def jax_facades():
    """One JAX facade per configuration, built and configured at first
    use and reused by every test of the module."""
    made = {}

    def get(name):
        if name not in made:
            kw, sgbm, _ = CONFIGS[name]
            vid = det.StereoDepthEstimatorVideo(target_fps=0, **kw)
            vid.configure_sgbm(**sgbm)
            made[name] = vid
        return made[name]

    return get


def port_facade(name):
    kw, sgbm, _ = CONFIGS[name]
    vid = dt.StereoDepthEstimatorVideo(target_fps=0, device="cpu", **kw)
    vid.configure_sgbm(**sgbm)
    return vid


def run(vid, left, right, stop_after=None, **attrs):
    """Stream left/right through vid with attrs set on it; returns the
    yielded depth maps and each frame's metrics."""
    vid.left_source, vid.right_source = left, right
    for k, v in attrs.items():
        setattr(vid, k, v)
    depths, frames = [], []
    for depth in vid.estimate_depth():
        depths.append(depth)
        frames.append(vid.metrics.last)
        if stop_after is not None and len(depths) == stop_after:
            vid.stop()
    return depths, frames


def assert_stats_equal(got, want):
    assert got.frame_index == want.frame_index
    for key in ("disp_min", "disp_max", "disp_mean"):
        assert getattr(got, key) == getattr(want, key), key
    ulp = np.spacing(np.float32(want.valid_fraction))
    assert abs(got.valid_fraction - want.valid_fraction) <= ulp


@pytest.mark.parametrize("case", ["fast_threaded", "float16", "temporal_sequential",
                                  "calibrated"])
def test_stream_matches_jax(jax_facades, case):
    name = {"fast_threaded": "fast", "float16": "fast",
            "temporal_sequential": "temporal", "calibrated": "calibrated"}[case]
    attrs = dict(depth_dtype="float16") if case == "float16" else {}
    left, right = CONFIGS[name][2]
    want, want_m = run(jax_facades(name), left, right,
                       **dict(dict(depth_dtype="float32"), **attrs))
    vid = port_facade(name)
    got, got_m = run(vid, left, right, **attrs)
    assert len(got) == len(want) == len(left)
    assert vid.metrics.frames_failed == 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    if case == "calibrated":
        for g, w in zip(got, want):
            close = np.isclose(g, w, rtol=1e-5, atol=0) | (g == w)
            assert close.mean() >= 0.99
        return
    for g, w in zip(got_m, want_m):
        assert_stats_equal(g, w)
    if case == "float16":
        for g, w in zip(got, want):
            finite = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), finite)
            ulp = np.spacing(np.abs(w[finite]))
            assert (np.abs(g[finite].astype(np.float32) - w[finite].astype(np.float32))
                    <= ulp.astype(np.float32)).all()
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5)
    s, js = vid.metrics.summary(), jax_facades(name).metrics.summary()
    for key in ("frames", "frames_failed", "bytes_per_frame_in", "bytes_per_frame_out"):
        assert s[key] == js[key], key


def _failing_matcher(core, fail_on):
    """Wrap core's matcher (the injectable compute_disparity seam) so that
    the calls whose index is in fail_on raise."""
    matcher, calls = core.compute_disparity, [0]

    def compute_disparity(left, right):
        calls[0] += 1
        if calls[0] - 1 in fail_on:
            raise RuntimeError("injected matcher failure")
        return matcher(left, right)

    return compute_disparity


@pytest.mark.parametrize("fail", ["one", "all"])
def test_failure_isolation_matches_jax(jax_facades, fail):
    left, right = FRAMES
    budget = dt.StereoDepthEstimatorVideo.MAX_CONSECUTIVE_FAILURES
    assert budget == det.StereoDepthEstimatorVideo.MAX_CONSECUTIVE_FAILURES
    if fail == "all":
        left, right = [left[0]] * (budget + 3), [right[0]] * (budget + 3)
    fail_on = {2} if fail == "one" else set(range(len(left)))
    jvid, vid = jax_facades("fast"), port_facade("fast")
    results = []
    for v in (jvid, vid):
        v.core.compute_disparity = _failing_matcher(v.core, fail_on)
        try:
            if fail == "all":
                with pytest.raises(RuntimeError, match="consecutive frame failures"):
                    run(v, left, right, use_threading=False, depth_dtype="float32")
                results.append(([], v.metrics.frames, v.metrics.frames_failed))
            else:
                out, _ = run(v, left, right, use_threading=False, depth_dtype="float32")
                results.append((out, v.metrics.frames, v.metrics.frames_failed))
        finally:
            del v.core.compute_disparity
    (want, jframes, jfailed), (got, frames, failed) = results
    assert (frames, failed) == (jframes, jfailed)
    assert (frames, failed) == ((len(left) - 1, 1) if fail == "one" else (0, budget))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5)


@pytest.mark.parametrize("case", ["stop", "single_frame"])
def test_stop_and_single_frame_fps_match_jax(jax_facades, case):
    left, right = FRAMES
    counts = []
    for vid in (jax_facades("fast"), port_facade("fast")):
        if case == "stop":
            out, _ = run(vid, left, right, stop_after=1, use_threading=False,
                         depth_dtype="float32")
        else:
            out, _ = run(vid, left[:1], right[:1], depth_dtype="float32")
            # No inter-frame interval: the rate is the latency-derived one.
            lat = vid.metrics.last.latency_ms
            assert vid.metrics.throughput_fps == pytest.approx(1000.0 / lat)
        counts.append((len(out), vid.metrics.frames))
    assert counts[0] == counts[1] == (1, 1)
