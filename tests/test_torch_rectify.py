"""The PyTorch port's full-calibration (rectified) path against the JAX
package on the CPU: calibration maths, the remap's plain version, the
resize, the size-mismatch warning and StereoDepthEstimator end to end on
a mild rig (the JAX bench's rectified configuration, bench.py:377-391,
at 64x240).

Tolerances, with their reasons:
- calib: both packages run the same numpy code, so exact.
- remap atol 1e-4 (0..255 scale): the port adds the four taps in the
  banded kernel's order; XLA may fuse and reorder the JAX sum.
- resize: the port is held to a float64 evaluation of the same weights
  at atol 1e-4, and to JAX at atol 2e-3: XLA's einsum on the CPU is
  itself up to 1.6e-3 from float64 on the 1.5x upscale below (the port
  2.5e-5).
- raw disparity equal on >= 99 % of pixels: the rectified images are
  fractional, and the JAX package's XLA BT cost and the port's add the
  SAD window in another float32 order, so a few int16 cells truncate the
  other way and a few pixels pick another disparity (99.74 % equal here).
  Without WLS the final disparity is a median of the raw one: equal on
  >= 99 %, depth rtol 1e-5 where equal. With WLS the guided filter's box
  means run in another order too: within 1e-3 on >= 99 %.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depthestimation_tpu as det
from depthestimation_tpu import calib as jcalib
from depthestimation_tpu import config as jconfig
from depthestimation_tpu.ops import color as jcolor
from depthestimation_tpu.ops import remap as jremap
import depthestimation_torch as dt
from depthestimation_torch import calib, config
from depthestimation_torch.ops import color, cuda_sgm, remap

H, W, D, SHIFT = 64, 240, 32, 6
FX = 1000.0 * W / 1920  # the bench rig's field of view at this width


def rig_kwargs(h=H, w=W):
    """configure_sgbm keys of the mild rig: centred K, a 0.25 degree roll,
    light radial distortion, 0.12 m baseline."""
    k = np.array([[FX, 0, w / 2], [0, FX, h / 2], [0, 0, 1]])
    th = np.deg2rad(0.25)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]])
    dist = np.array([-0.01, 0.002, 0.0, 0.0, 0.0])
    return dict(cam_matrix_L=k, cam_matrix_R=k, image_width=w, image_height=h,
                dist_coeff_L=dist, dist_coeff_R=dist, rotation=rot,
                focal_length=FX, baseline=0.12)


def textured_rgb(h, w, shift, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    base = ((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0).astype(np.uint8)
    return [np.repeat(img[..., None], 3, -1).copy()
            for img in (base[:, :w], base[:, shift:])]


def test_configure_sgbm_passes_calibration():
    est = dt.StereoDepthEstimator(device="cpu")
    est.configure_sgbm(**rig_kwargs())
    cfg = est.core.cfg
    assert cfg.has_full_calibration()
    kw = rig_kwargs()
    np.testing.assert_array_equal(cfg.calib.K_l(), kw["cam_matrix_L"])
    np.testing.assert_array_equal(cfg.calib.dist_r(), kw["dist_coeff_R"])
    np.testing.assert_array_equal(cfg.calib.R(), kw["rotation"])
    np.testing.assert_array_equal(cfg.calib.T(cfg.baseline), [-0.12, 0, 0])
    jcfg = jconfig.SGMConfig().updated(**kw)
    assert config.config_from_dict(dataclasses.asdict(jcfg)) == cfg


def test_calib_matches_jax():
    cfg = config.SGMConfig().updated(**rig_kwargs())
    jcfg = jconfig.SGMConfig().updated(**rig_kwargs())
    c, jc = cfg.calib, jcfg.calib
    size = (W, H)
    args = (c.K_l(), c.dist_l(), c.K_r(), c.dist_r(), size, c.R(), c.T(0.12))
    for alpha in (-1.0, 0.0, 1.0):
        for got, want in zip(calib.stereo_rectify(*args, alpha=alpha),
                             jcalib.stereo_rectify(*args, alpha=alpha)):
            np.testing.assert_array_equal(got, want)
    got = calib.rectification_maps(c, 0.12)
    want = jcalib.rectification_maps(jc, 0.12)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    pts = np.array([[0.0, 0.0], [W - 1.0, H - 1.0], [17.5, 40.25]])
    np.testing.assert_array_equal(
        calib._undistort_points(pts, c.K_l(), c.dist_l()),
        jcalib._undistort_points(pts, c.K_l(), c.dist_l()))

    cache = calib.RectificationCache()
    mx, my = cache.device_maps(c, 0.12, 1.0, "cpu")
    assert cache.device_maps(c, 0.12, 1.0, "cpu")[0] is mx
    assert mx.shape == (2, H, W) and mx.dtype == torch.float32
    np.testing.assert_array_equal(mx[1].numpy(), want["map_x_r"])
    np.testing.assert_array_equal(my[0].numpy(), want["map_y_l"])
    assert cache.device_maps(c, 0.13, 1.0, "cpu")[0] is not mx


def test_remap_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (48, 200)).astype(np.float32)
    yy, xx = np.mgrid[0:48, 0:200].astype(np.float32)
    # Smooth warps that leave the image on every side.
    map_x = (xx * 1.02 - 1.6 + 2.5 * np.sin(yy / 7)).astype(np.float32)
    map_y = (yy * 1.03 - 1.2 + 1.5 * np.cos(xx / 13)).astype(np.float32)
    assert (map_x < 0).any() and (map_x > 199).any()
    assert (map_y < 0).any() and (map_y > 47).any()
    want = np.asarray(jremap.remap_bilinear(jnp.asarray(img), map_x, map_y))
    got = remap.remap_bilinear(torch.tensor(img), torch.tensor(map_x),
                               torch.tensor(map_y))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert (got.numpy()[map_x < -1] == 0).all()
    # A batch of two is the two images remapped one by one.
    img2 = np.stack([img, img[::-1].copy()])
    mx2, my2 = np.stack([map_x, map_x[::-1]]), np.stack([map_y, map_y])
    both = remap.remap_bilinear(torch.tensor(img2), torch.tensor(mx2),
                                torch.tensor(my2))
    for i in range(2):
        assert torch.equal(both[i], remap.remap_bilinear(
            torch.tensor(img2[i]), torch.tensor(mx2[i]), torch.tensor(my2[i])))
    # Plain version on the CPU: no launch and no call counted.
    assert cuda_sgm.LAUNCHES["remap"] == 0
    assert cuda_sgm.CALLS["remap"] == 0


def test_remap_border_rules_match_jax():
    """Every pair of 16 coordinates per axis on a 16x16 image: exactly 0
    and n-1, just below 0, just past n-1 (by 1e-3 and by one float step),
    -1 and n, integers and halves. Held to both JAX routes (the banded sum
    for host maps, the gather for traced ones) at the remap's 1e-4; exact
    where both coordinates are integers (weights 0 and 1); exactly 0 where
    both taps of an axis leave the image."""
    n = 16
    eps = np.float32(1e-3)
    last = np.float32(n - 1)
    vals = np.array([0, last, -eps, last + eps,
                     np.nextafter(np.float32(0), np.float32(-1)),
                     np.nextafter(last, np.float32(n)), -1, n, 3, 7.5, 0.25,
                     n - 2.5, -1 + eps, n - eps, 14, -2.5], np.float32)
    map_x, map_y = np.meshgrid(vals, vals)
    img = np.random.default_rng(3).uniform(0, 255, (n, n)).astype(np.float32)
    got = remap.remap_bilinear_plain(torch.tensor(img), torch.tensor(map_x),
                                     torch.tensor(map_y)).numpy()
    for want in (jremap.remap_bilinear(jnp.asarray(img), map_x, map_y),
                 jremap._remap_gather(jnp.asarray(img), jnp.asarray(map_x),
                                      jnp.asarray(map_y))):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        whole = (map_x == np.round(map_x)) & (map_y == np.round(map_y))
        np.testing.assert_array_equal(got[whole], want[whole])
    outside = (map_x >= n) | (map_x < -1) | (map_y >= n) | (map_y < -1)
    assert outside.any() and (got[outside] == 0).all()
    inside = (map_x >= 0) & (map_x <= last) & (map_y >= 0) & (map_y <= last)
    assert (got[inside] > 0).all()


@pytest.mark.parametrize("out_hw", [(96, 300), (31, 47), (48, 120)])
def test_resize_bilinear_matches_jax(out_hw):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (48, 200)).astype(np.float32)
    want = np.asarray(jcolor.resize_bilinear(jnp.asarray(img), out_hw))
    got = color.resize_bilinear(torch.tensor(img), out_hw)
    assert got.shape == out_hw and got.dtype == torch.float32
    wy = color._linear_weights(48, out_hw[0], "cpu").double().numpy()
    wx = color._linear_weights(200, out_hw[1], "cpu").double().numpy()
    np.testing.assert_allclose(got.numpy(), wy.T @ img.astype(np.float64) @ wx,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_size_mismatch_warns_and_resizes():
    left, right = textured_rgb(H // 2, W // 2, SHIFT // 2, seed=4)
    pipe = dt.StereoPipeline(device="cpu")
    pipe.configure(num_disp=D, **rig_kwargs())
    jpipe = det.StereoPipeline()
    jpipe.configure(num_disp=D, **rig_kwargs())
    with pytest.warns(RuntimeWarning, match="calibration size"):
        got = pipe.prepare_rectified(left, right)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jpipe.prepare_rectified(left, right)
    for g, w_ in zip(got, want):
        assert g.shape == (H, W)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-3)


@pytest.mark.parametrize("wls_filter", [False, True])
def test_estimator_rectified_matches_jax(wls_filter):
    left, right = textured_rgb(H, W, SHIFT, seed=5)
    kw = dict(num_disp=D, sgbm_mode="hh4", speckle_window_size=0,
              wls_filter=wls_filter, **rig_kwargs())
    jest = det.StereoDepthEstimator()
    est = dt.StereoDepthEstimator(device="cpu")
    for e in (jest, est):
        e.left_source, e.right_source = left, right
        e.configure_sgbm(**kw)
        e.core.fast_mode = True
    jdisp, jdepth = jest.estimate_depth()
    disp, depth = est.estimate_depth()
    assert disp.shape == jdisp.shape == (H, W - D)
    assert disp.dtype == np.float32
    # The rectified images agree with JAX's to the remap's tolerance.
    np.testing.assert_allclose(est.core.left_rectified.numpy(),
                               np.asarray(jest.core.left_rectified),
                               rtol=0, atol=1e-4)
    jraw = np.asarray(jest.core.compute_disparity(jest.core.left_rectified,
                                                  jest.core.right_rectified))
    raw = est.core.compute_disparity(est.core.left_rectified,
                                     est.core.right_rectified).numpy()
    assert (raw == jraw).mean() >= 0.99, (raw == jraw).mean()
    if wls_filter:
        # WLS smooths in float32, so disparities equal as integers come out
        # equal to 1e-3, and depth (f*B/d) to the same relative share.
        same = np.isclose(disp, jdisp, rtol=0, atol=1e-3)
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(depth[same], jdepth[same], rtol=1e-3)
    else:
        same = disp == jdisp
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(depth[same], jdepth[same], rtol=1e-5)
    assert (np.abs(disp - SHIFT) <= 1).mean() > 0.95
