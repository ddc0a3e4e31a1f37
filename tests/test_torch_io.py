"""The PyTorch port's streaming support modules against the JAX package on
the CPU: synthetic scenes, per-frame metrics, the threaded input pipeline
(host frames) and the live views of viz.

Tolerances: synthetic scenes, metrics and live views are the same numpy
code on the same inputs, so exact. Every wait on the input thread is
bounded, and every thread is joined with a timeout.
"""

import time

import numpy as np
import pytest
import torch

from depthestimation_tpu import metrics as jmetrics
from depthestimation_tpu.ops import color as jcolor
from depthestimation_tpu import viz as jviz
from depthestimation_tpu.io import synthetic as jsynthetic
import depthestimation_torch as dt
from depthestimation_torch import metrics, profiling, viz
from depthestimation_torch.io import input as port_input, synthetic
from depthestimation_torch.ops import color
from depthestimation_torch.io.threaded import StereoInputPipeline
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("what", ["pair", "stream"])
def test_synthetic_matches_jax(what):
    if what == "pair":
        got = synthetic.synthesize_stereo_pair(96, 48, 16, seed=3, shift=1.6)
        want = jsynthetic.synthesize_stereo_pair(96, 48, 16, seed=3, shift=1.6)
    else:
        got = synthetic.synthetic_stream(3, 96, 32, 16, seed=1)
        want = jsynthetic.synthetic_stream(3, 96, 32, 16, seed=1)
        got, want = [*got[0], *got[1]], [*want[0], *want[1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert dt.synthesize_stereo_pair is synthetic.synthesize_stereo_pair


def _disp_depth(seed=0):
    """A disparity map on the 1/16 grid with invalid pixels, and depth
    with inf, nan and 0 among its values."""
    rng = np.random.default_rng(seed)
    disp = rng.integers(-16, 400, (24, 40)).astype(np.float32) / 16.0
    depth = (50.0 / np.maximum(disp, 0.5)).astype(np.float32)
    depth[0, :5] = np.inf
    depth[1, :3] = np.nan
    depth[2, :4] = 0.0
    return disp, depth


@pytest.mark.parametrize("how", ["from_map", "from_stats"])
def test_frame_metrics_match_jax(how):
    disp, depth = _disp_depth()
    if how == "from_map":
        got = metrics.compute_frame_metrics(disp, depth, 3, 12.5)
        want = jmetrics.compute_frame_metrics(disp, depth, 3, 12.5)
    else:
        stats = np.array([0.75, 0.0625, 24.9375, 7.3125], np.float32)
        got = metrics.frame_metrics_from_stats(
            torch.tensor(stats), depth.astype(np.float16), 3, 12.5)
        want = jmetrics.frame_metrics_from_stats(
            stats, depth.astype(np.float16), 3, 12.5)
    assert got.to_json() == want.to_json()


def test_metrics_aggregator_summary_matches_jax():
    got, want = metrics.MetricsAggregator(), jmetrics.MetricsAggregator()
    disp, depth = _disp_depth(1)
    for agg, mod in ((got, metrics), (want, jmetrics)):
        for i, lat in enumerate((30.0, 10.0, 12.0)):
            agg.update(mod.compute_frame_metrics(disp, depth, i, lat))
            agg.record_bytes(bytes_in=2 * 24 * 40 * 3, bytes_out=16 + depth.nbytes)
        agg.record_failure()
    g, w = got.summary(), want.summary()
    for key in ("frames", "frames_failed", "mean_latency_ms",
                "steady_mean_latency_ms", "bytes_per_frame_in",
                "bytes_per_frame_out"):
        assert g[key] == w[key], key
    assert g["throughput_fps"] > 0


def _tagged_frames(n, h=8, w=12):
    """n RGB frame pairs; pair i is filled with the value i."""
    left = [np.full((h, w, 3), i, np.uint8) for i in range(n)]
    return left, [f.copy() for f in left]


class _Poison:
    """Opaque object that the decode stage's downscale cannot handle."""


def _endless(h=8, w=12):
    while True:
        yield np.zeros((h, w, 3), np.uint8)


def _drain(pipe, limit=50):
    seen = []
    for _ in range(limit):
        pair = pipe.read(timeout=2.0)
        if pair is None:
            break
        seen.append(pair)
    return seen


@pytest.mark.parametrize("case", ["offline", "live", "corrupt", "failures", "stop"])
def test_input_pipeline(case):
    n = 6
    left, right = _tagged_frames(n)
    kw = {}
    if case == "corrupt":
        left[2] = _Poison()
        kw["downscale_factor"] = 0.5
    elif case == "failures":
        left = [_Poison()] * (StereoInputPipeline.MAX_CONSECUTIVE_FAILURES + 3)
        right = _tagged_frames(len(left))[1]
        kw["downscale_factor"] = 0.5
    elif case == "stop":
        left, right = _endless(), _endless()
    pipe = StereoInputPipeline(left, right, prefetch=2,
                               drop_frames=case == "live", **kw)
    pipe.start()
    worker = pipe._worker
    try:
        if case == "offline":
            seen = []
            for pair in _drain(pipe):
                time.sleep(0.01)  # the producer meets a full buffer
                seen.append(int(pair[0][0, 0, 0]))
            assert seen == list(range(n))
            assert pipe.frames_dropped == 0
        elif case == "live":
            # Let the producer run to its end before reading: the buffer
            # keeps the newest pair and the end marker.
            worker.join(timeout=5.0)
            assert not worker.is_alive()
            seen = [int(p[0][0, 0, 0]) for p in _drain(pipe)]
            assert seen == [n - 1]
            assert pipe.frames_dropped == n - 1
        elif case == "corrupt":
            seen = _drain(pipe)
            assert len(seen) == n - 1 and pipe.frames_failed == 1
            assert all(p[0].shape == (4, 6, 3) for p in seen)  # downscaled
        elif case == "failures":
            assert _drain(pipe) == []
            assert pipe.frames_failed == StereoInputPipeline.MAX_CONSECUTIVE_FAILURES
        else:
            assert len(_drain(pipe, limit=3)) == 3
            t0 = time.perf_counter()
            pipe.stop()
            assert time.perf_counter() - t0 < 2.0
            assert not worker.is_alive()
    finally:
        pipe.stop()
    assert not worker.is_alive()


@pytest.mark.parametrize("render", ["render_depth_live", "render_depth_live_gray"])
def test_live_view_matches_jax(render):
    _, depth = _disp_depth(2)
    depth[3, :6] = 80.0  # beyond the 50 m display cap
    got = getattr(viz, render)(depth, 12.0)
    want = getattr(jviz, render)(depth, 12.0)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    blank = getattr(viz, render)(np.zeros((4, 5), np.float32), 1.0)
    np.testing.assert_array_equal(blank, np.zeros((4, 5, 3), np.uint8))


def test_visualize_results_headless():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = dt.StereoDepthEstimator(device="cpu")
    with pytest.raises(ValueError, match="estimate_depth"):
        est.visualize_results()
    rng = np.random.default_rng(4)
    base = rng.integers(0, 255, (24, 72)).astype(np.uint8)
    est.left_source, est.right_source = base[:, :64], base[:, 4:68]
    est.configure_sgbm(num_disp=16, focal_length=500.0, baseline=0.1)
    est.core.fast_mode = True
    est.estimate_depth()
    try:
        est.visualize_results()
        assert len(plt.get_fignums()) == 2  # disparity and depth figures
    finally:
        plt.close("all")


def test_profiling_hooks(tmp_path):
    """StageTimer's summary, and a trace with a named range written as a
    Chrome trace (CPU activity only here)."""
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer("double") as t:
            t.out = [torch.ones(8) * 2, {"x": torch.zeros(2)}]
    summary = timer.summary()
    assert list(summary) == ["double"] and summary["double"]["count"] == 2
    assert profiling.hard_sync(t.out) is t.out
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("stage_a"):
            torch.ones(64).sum()
    assert any(e.name == "stage_a" for e in prof.events())
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_top_level_exports_match_jax():
    """Every name the JAX package exports at its top level, the port
    exports too; the visualize_* functions are viz's."""
    import depthestimation_tpu as det

    assert set(det.__all__) <= set(dt.__all__)
    for name in dt.__all__:
        assert getattr(dt, name) is not None, name
    for name in ("visualize_stereo_pair", "visualize_disparity", "visualize_depth",
                 "visualize_disparity_and_depth"):
        assert getattr(dt, name) is getattr(viz, name)


def test_area_downscale_without_pil_covers_the_image(monkeypatch):
    """Without PIL, a downscale by a factor not of the form 1/n averages
    over the whole image (the JAX package's area resize) instead of
    subsampling and cropping it. Equal to the port's color.resize_area;
    within one level of JAX's (float32 sums in another order can round a
    value near .5 the other way)."""
    import sys

    img = np.random.default_rng(0).integers(0, 256, (100, 160, 3), dtype=np.uint8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = port_input._area_downscale_np(img, 0.37)
    assert got.shape == (37, 59, 3) and got.dtype == np.uint8
    want = color.resize_area(torch.from_numpy(img), (37, 59)).numpy()
    np.testing.assert_array_equal(got, want)
    jax_out = np.asarray(jcolor.resize_area(img, (37, 59))).astype(np.int16)
    assert np.abs(got.astype(np.int16) - jax_out).max() <= 1
