"""The PyTorch port above 256 disparities and on the float32 route, against
the JAX package on the CPU.

- Above 256 disparities (K2 and K3's wide variants on the card; their
  plain versions here) the port equals JAX bit for bit wherever JAX is
  right: with the LR check off, or where no pixel picks a disparity of 256
  or more.
- With the LR check on, JAX's claim key cost*256 + d0 decodes d0 with
  & 255 (depthestimation_tpu/ops/wta.py:54-73), so JAX invalidates every
  pixel whose disparity is 256 or more. The port packs the key with the
  argmin's shift instead and is held to OpenCV's claim-and-check rule,
  written out pixel by pixel in numpy below, and to cv2.StereoSGBM.
- Configs outside the kernels' int16 bounds or launch shapes take the
  float32 route, as JAX takes its XLA route, and equal JAX bit for bit.

Four tests, so that pytest-xdist deals this file after the long Pallas
file; every input is a seeded integer texture, so every sum is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depthestimation_tpu as det
from depthestimation_tpu import config as jconfig
from depthestimation_tpu import pipeline as jpipeline
from depthestimation_torch import config, pipeline
from depthestimation_torch.examples import stereo
from depthestimation_torch.io import png
from depthestimation_torch.io.synthetic import synthesize_stereo_pair
from depthestimation_torch.ops import cuda_sgm, wta
from test_torch_surface import MIDDLEBURY, one_torch_thread  # noqa: F401 (a fixture)


def shifted_pair(h, w, shift, seed):
    """Integer-valued float32 pair with left[x] == right[x - shift]."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    base = np.round((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0)
    return base[:, :w].copy(), base[:, shift:].copy()


def both(kw):
    """The same config in both packages."""
    jcfg = jconfig.SGMConfig(**kw)
    return jcfg, config.config_from_dict(dataclasses.asdict(jcfg))


def raw_pair(left, right, kw):
    """(port, JAX) raw_disparity on the pair, and the port's float32 route
    calls."""
    jcfg, cfg = both(kw)
    cuda_sgm.reset_launches()
    got = pipeline.raw_disparity(torch.tensor(left), torch.tensor(right), cfg).numpy()
    routed = cuda_sgm.CALLS["float32_route"]
    want = np.asarray(jpipeline.raw_disparity(jnp.asarray(left), jnp.asarray(right), jcfg))
    return got, want, routed


def lr_bad_opencv(d0, min_s, valid, max_diff, min_disp):
    """OpenCV's LR check, pixel by pixel: every valid pixel x claims right
    pixel x - d0 - min_disp unless a claimant with a smaller (cost, d0) is
    there; a pixel fails when its right pixel is outside the image, has no
    claimant, or its claimant's d0 differs from its own by more than
    max_diff."""
    h, w = d0.shape
    bad = np.zeros((h, w), bool)
    for y in range(h):
        claim = {}
        for x in range(w):
            xr = x - d0[y, x] - min_disp
            if valid[y, x] and xr >= 0:
                key = (min_s[y, x], d0[y, x])
                claim[xr] = min(claim.get(xr, key), key)
        for x in range(w):
            xr = x - d0[y, x] - min_disp
            bad[y, x] = (xr < 0 or xr not in claim
                         or abs(claim[xr][1] - d0[y, x]) > max_diff)
    return bad


def wta_inputs(left, right, cfg):
    """(d0, min S, uniqueness survivors) of sgbm_3way's aggregated volume,
    through the kernels' plain versions, as numpy."""
    c = cuda_sgm.cost_volume(torch.tensor(left), torch.tensor(right), cfg)
    s = cuda_sgm.hscan(c, cfg)
    s = cuda_sgm.rowsweep(c, s, cfg, (0,), False, cuda_sgm._final_dtype(cfg))
    s = s.numpy().astype(np.int64)
    d0 = s.argmin(-1)
    min_s = s.min(-1)
    near = np.abs(np.arange(s.shape[-1]) - d0[..., None]) <= 1
    competitor = np.where(near, np.iinfo(np.int64).max, s).min(-1)
    valid = ~(competitor * (100 - cfg.uniqueness_ratio) < min_s * 100)
    return d0, min_s, valid


def test_wide_range_lr_off_matches_jax():
    """D = 272 at 16x420 with and without the in-matcher speckle filter,
    and D = 1024 at 6x1040, LR check off: bit for bit, on the kernels'
    route (their plain versions here)."""
    left, right = shifted_pair(16, 420, 264, seed=0)
    for speckle in (0, 50):
        got, want, routed = raw_pair(left, right, dict(
            num_disp=272, disp12_max_diff=-1, speckle_window_size=speckle))
        np.testing.assert_array_equal(got, want)
        assert routed == 0
        assert (np.abs(got[:, 300:] - 264) <= 1).mean() > 0.99
    left, right = shifted_pair(6, 1040, 600, seed=1)
    got, want, routed = raw_pair(left, right, dict(
        num_disp=1024, disp12_max_diff=-1, speckle_window_size=0))
    np.testing.assert_array_equal(got, want)
    assert routed == 0
    assert (np.abs(got[:, 1024:] - 600) <= 1).mean() > 0.9


def test_wide_range_lr_check_follows_opencv():
    """The pair shifted by 264 px, D = 272, LR check on (max diff 1), no
    speckle filter: JAX invalidates the whole shifted region; the port's LR
    mask equals OpenCV's rule exactly, and its valid share is cv2's within
    0.01. At D = 128 (shift 100) the rule, the port and JAX agree."""
    for shift, d, seed in ((100, 128, 3), (264, 272, 0)):
        left, right = shifted_pair(16, 420, shift, seed=seed)
        kw = dict(num_disp=d, speckle_window_size=0)
        _, cfg = both(kw)
        d0, min_s, valid = wta_inputs(left, right, cfg)
        bad = wta.lr_invalidate(*(torch.tensor(a) for a in (d0.astype(np.int32),
                                                           min_s.astype(np.int32), valid)),
                                cfg.disp12_max_diff, cfg.min_disp, d).numpy()
        np.testing.assert_array_equal(bad, lr_bad_opencv(d0, min_s, valid,
                                                         cfg.disp12_max_diff, cfg.min_disp))
        got, want, _ = raw_pair(left, right, kw)
        np.testing.assert_array_equal(got < 0, ~valid | bad)
        region = np.s_[:, 300:]
        if d <= 256:
            np.testing.assert_array_equal(got, want)
        else:
            assert (want[region] > 0).mean() < 0.01  # JAX's fault
        assert (np.abs(got[region] - shift) <= 1).mean() > 0.99
    cv2 = pytest.importorskip("cv2")
    sgbm = cv2.StereoSGBM_create(
        minDisparity=0, numDisparities=d, blockSize=cfg.block_size, P1=cfg.p1, P2=cfg.p2,
        disp12MaxDiff=cfg.disp12_max_diff, uniquenessRatio=cfg.uniqueness_ratio,
        speckleWindowSize=0, preFilterCap=cfg.prefilter_cap,
        mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY)
    ref = sgbm.compute(left.astype(np.uint8), right.astype(np.uint8)) / 16.0
    assert abs((got[region] > 0).mean() - (ref[region] > 0).mean()) <= 0.01


def test_float32_route_matches_jax():
    """BT at block_size 15 (past the int16 bounds) and D = 128 on a 120 px
    wide image (w <= D + min_disp) take the float32 route, counted as
    such, and equal JAX's XLA route bit for bit. On the card that route
    stops at JAX's 1 << 26 cells, a rule of the config, shape and device.
    (No speckle filter: it follows either route alike, and test 1 holds it.)"""
    for (h, w), kw in (((16, 340), dict(block_size=15, num_disp=64, speckle_window_size=0)),
                       ((12, 120), dict(num_disp=128, speckle_window_size=0))):
        left, right = shifted_pair(h, w, 9, seed=h + w)
        _, cfg = both(kw)
        assert not cuda_sgm.kernels_supported(cfg, (h, w))
        got, want, routed = raw_pair(left, right, kw)
        np.testing.assert_array_equal(got, want)
        assert routed == 1
    cfg = config.SGMConfig(num_disp=256)
    for shape, too_big in (((512, 512), False), ((512, 520), True)):
        pipeline.check_float32_route(cfg, shape, "cpu")
        if too_big:
            with pytest.raises(ValueError, match="too large for the float32 matcher"):
                pipeline.check_float32_route(cfg, shape, "cuda")
        else:
            pipeline.check_float32_route(cfg, shape, torch.device("cuda"))


def test_example_at_full_size_ndisp(tmp_path):
    """examples.stereo at downscale 1.0 with its default ndisp 280 (D = 288)
    on a 600x40 synthetic pair written as PNG, against the JAX package's
    stages on its facade's inputs and config (its matcher compiled alone,
    its postprocess op by op: the facade's fused postprocess moves a few
    outlier decisions, ROADMAP Queue 3). The scene's disparities stay
    below 256, so JAX's LR check is right here."""
    paths = [str(tmp_path / name) for name in ("im0.png", "im1.png")]
    for path, img in zip(paths, synthesize_stereo_pair(600, 40, 280, seed=0)):
        png.write_png(path, img)
    est = stereo.run([*paths, "--downscale", "1.0", "--device", "cpu", "--no-viz"])
    assert est.core.cfg.num_disp == 288
    ref = det.StereoDepthEstimator(*paths, downscale_factor=1.0)
    ref.configure_sgbm(**MIDDLEBURY)
    cfg = ref.core.cfg
    left, right = ref.core.prepare_rectified(ref.left_source, ref.right_source)
    raw = jpipeline.raw_disparity(left, right, cfg)
    disp, depth = jpipeline.postprocess_and_depth(raw, cfg, 1.0, False, guide=left)
    assert est.disparity_map.shape == (40, 312)
    np.testing.assert_array_equal(est.disparity_map, np.asarray(disp))
    np.testing.assert_allclose(est.depth_map, np.asarray(depth), rtol=1e-5)
    assert (est.disparity_map > 0).mean() > 0.85
