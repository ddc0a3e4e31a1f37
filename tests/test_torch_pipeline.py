"""The PyTorch port's whole slice against the JAX package on the CPU:
raw disparity from the matcher and StereoDepthEstimator end to end on a
pair written to PNG files (fast, full and WLS modes)."""

import dataclasses

import numpy as np
import pytest
import torch

import depthestimation_tpu as det
from depthestimation_tpu import config as jconfig
from depthestimation_tpu import pipeline as jpipeline
import depthestimation_torch as dtorch
from depthestimation_torch import config, pipeline
from depthestimation_torch.ops import cuda_sgm

H, W, D, SHIFT = 40, 200, 32, 9


def textured_pair(h, w, shift, seed):
    """Grayscale uint8 pair: a smoothed random texture and its copy shifted
    by `shift` pixels (left[x] == right[x - shift])."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0
    base = base.astype(np.uint8)
    return base[:, :w].copy(), base[:, shift:].copy()


@pytest.mark.parametrize(
    "kw",
    [dict(num_disp=D), dict(num_disp=48, min_disp=3, uniqueness_ratio=0)],
)
def test_raw_disparity_exact(kw):
    left, right = textured_pair(H, W, SHIFT, seed=1)
    jcfg = jconfig.SGMConfig(**kw)
    cfg = config.config_from_dict(dataclasses.asdict(jcfg))
    want = np.asarray(jpipeline.raw_disparity(
        left.astype(np.float32), right.astype(np.float32), jcfg))
    got = pipeline.raw_disparity(torch.tensor(left, dtype=torch.float32),
                                 torch.tensor(right, dtype=torch.float32), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrappers took their plain versions on the CPU: no launches and
    # no calls counted.
    assert not any(cuda_sgm.LAUNCHES.values())
    assert not any(cuda_sgm.CALLS.values())
    assert (np.abs(want[:, kw["num_disp"]:] - SHIFT) <= 0.5).mean() > 0.9


@pytest.fixture(scope="module")
def png_pair(tmp_path_factory):
    from PIL import Image

    left, right = textured_pair(H, W, SHIFT, seed=2)
    rng = np.random.default_rng(3)
    tint = rng.integers(0, 3, (H, W, 3), dtype=np.uint8)  # RGB, not gray
    paths = []
    for name, img in (("im0.png", left), ("im1.png", right)):
        rgb = np.clip(img[..., None].astype(np.int32) + tint, 0, 255).astype(np.uint8)
        path = tmp_path_factory.mktemp("pair") / name
        Image.fromarray(rgb).save(path)
        paths.append(str(path))
    return paths


def run_both(paths, fast_mode, **kw):
    kw = dict(num_disp=D, focal_length=700.0, baseline=0.12, **kw)
    jest = det.StereoDepthEstimator(*paths)
    jest.configure_sgbm(**kw)
    jest.core.fast_mode = fast_mode
    est = dtorch.StereoDepthEstimator(*paths, device="cpu")
    est.configure_sgbm(**kw)
    est.core.fast_mode = fast_mode
    want = jest.estimate_depth()
    got = est.estimate_depth()
    assert got[0].shape == want[0].shape == (H, W - D)
    assert got[0].dtype == want[0].dtype == np.float32
    return got, want


def test_estimator_fast_mode_exact(png_pair):
    (disp, depth), (jdisp, jdepth) = run_both(png_pair, fast_mode=True)
    np.testing.assert_array_equal(disp, jdisp)
    assert (np.abs(disp - SHIFT) <= 0.5).mean() > 0.9
    # Same disparities, one float32 division each side.
    np.testing.assert_allclose(depth, jdepth, rtol=1e-5)


def test_estimator_full_mode(png_pair):
    (disp, depth), (jdisp, jdepth) = run_both(png_pair, fast_mode=False,
                                              hole_filling=True)
    # Exact: the box sums behind detect_outliers and the fill run in the
    # same order as XLA's on this input, so no borderline pixel flips.
    np.testing.assert_array_equal(disp, jdisp)
    np.testing.assert_allclose(depth, jdepth, rtol=1e-5)


def test_estimator_wls(png_pair):
    (disp, depth), (jdisp, jdepth) = run_both(png_pair, fast_mode=True,
                                              speckle_window_size=0,
                                              wls_filter=True)
    # Guided-filter box means in another summation order.
    np.testing.assert_allclose(disp, jdisp, rtol=1e-5)
    np.testing.assert_allclose(depth, jdepth, rtol=1e-5)
