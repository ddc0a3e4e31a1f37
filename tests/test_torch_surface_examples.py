"""The PyTorch port's examples on the CPU against the JAX package and
the single-pair path, from PNG files (part 2 of the surface's tests;
tests/test_torch_surface.py says why they are split). Tolerances:
- examples.stereo against the JAX package: disparity equal, depth rtol
  1e-5 (float32 division on two backends). At 0.5 against JAX's
  StereoDepthEstimator. At 0.2 against JAX's matcher and its postprocess
  run op by op: JAX's facade compiles the whole postprocess as one XLA
  program, whose fusion moves the outlier decision on a few pixels
  (ROADMAP, Queue 3), while its stages run alone equal the port;
- stereo_live: every frame equal to the single-pair path with the same
  temporal carry (the same ops in the same order);
- mono: finite depth >= 0.
"""

import jax
import numpy as np
import pytest

import depthestimation_tpu as det
from depthestimation_tpu import pipeline as jpipeline
from depthestimation_torch.examples import mono as mono_example
from depthestimation_torch.examples import stereo, stereo_live
from depthestimation_torch.io.input import _area_downscale_np
from depthestimation_torch.io.synthetic import DEMO_CALIB, synthetic_stream, write_demo_assets
from depthestimation_torch.pipeline import StereoPipeline
from test_torch_surface import MIDDLEBURY
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    return write_demo_assets(str(tmp_path_factory.mktemp("demo") / "assets"))


def _jax_facade(demo, factor, ndisp=MIDDLEBURY["num_disp"]):
    est = det.StereoDepthEstimator(demo["left"], demo["right"], downscale_factor=factor)
    est.configure_sgbm(**dict(MIDDLEBURY, num_disp=ndisp))
    return est


def _stereo_example(demo, factor, *args):
    return stereo.run([demo["left"], demo["right"], "--downscale", str(factor),
                       "--device", "cpu", "--no-viz", *args])


def test_example_stereo_matches_jax_facade(demo):
    """From the PNG files at 0.5 (240x320, D=16): the ROADMAP's spot
    check of StereoDepthEstimator with a downscale factor."""
    est = _stereo_example(demo, 0.5, "--ndisp", "32")
    assert est.core.cfg.num_disp == 16
    disp, depth = _jax_facade(demo, 0.5, ndisp=32).estimate_depth()
    assert est.disparity_map.shape == disp.shape == (240, 304)
    assert np.array_equal(est.disparity_map, disp)
    np.testing.assert_allclose(est.depth_map, depth, rtol=1e-5)


def test_example_stereo_matches_jax_stages(demo):
    """At 0.2 (96x128, D=64) against the JAX package's stages on the
    facade's inputs and config: its matcher compiled alone, then its
    postprocess and depth run op by op."""
    est = _stereo_example(demo, 0.2)
    ref = _jax_facade(demo, 0.2)
    assert np.array_equal(est.left_source, ref.left_source)
    cfg = ref.core.cfg
    left, right = ref.core.prepare_rectified(ref.left_source, ref.right_source)
    raw = jax.jit(lambda a, b: jpipeline.raw_disparity(a, b, cfg))(left, right)
    disp, depth = jpipeline.postprocess_and_depth(raw, cfg, 0.2, False, guide=left)
    assert est.disparity_map.shape == (96, 64)
    assert np.array_equal(est.disparity_map, np.asarray(disp))
    np.testing.assert_allclose(est.depth_map, np.asarray(depth), rtol=1e-5)


def test_example_stereo_live_equals_single_pair(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = []
    est = stereo_live.run(["--device", "cpu", "--no-viz", "--downscale", "0.2",
                           "--frames", "3", "--fps", "0"],
                          on_frame=lambda i, depth: got.append(depth))
    assert len(got) == 3 and est.metrics.summary()["frames_failed"] == 0
    ref = StereoPipeline(downscale_factor=0.2, device="cpu")
    ref.configure(num_disp=DEMO_CALIB["ndisp"], focal_length=DEMO_CALIB["focal_px"],
                  baseline=DEMO_CALIB["baseline_mm"] / 1000.0, doffs=0,
                  hole_filling=True, temporal_alpha=0.4)
    for i, (left, right) in enumerate(zip(*synthetic_stream(3))):
        want = ref.estimate_depth(_area_downscale_np(left, 0.2),
                                  _area_downscale_np(right, 0.2))[1]
        assert got[i].dtype == want.dtype and np.array_equal(got[i], want), i


def test_example_mono_gives_finite_depth(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    est = mono_example.run(["--device", "cpu", "--no-viz"])
    depth = est.depth_map
    assert depth.shape == (518, 686)
    assert np.isfinite(depth).all() and (depth >= 0).all()
