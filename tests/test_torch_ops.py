"""The PyTorch port's ops against the JAX package's XLA versions on the CPU.

Inputs are integer-valued arrays made with a seeded numpy RNG and handed
to both packages. Integer stages (cost volume, SGM sums, WTA on the 1/16
grid, median, speckle mask) must be bit-exact; float stages carry a
tolerance stated with its reason.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu import config as jconfig
from depthestimation_tpu.ops import color as jcolor
from depthestimation_tpu.ops import costs as jcosts
from depthestimation_tpu.ops import depth as jdepth
from depthestimation_tpu.ops import filters as jfilters
from depthestimation_tpu.ops import sgm as jsgm
from depthestimation_tpu.ops import wls as jwls
from depthestimation_tpu.ops import wta as jwta
from depthestimation_torch import config
from depthestimation_torch.ops import (color, costs, cuda_sgm, depth, filters,
                                       sgm, wls, wta)


def make_pair(h, w, d_true=5, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + d_true)).astype(np.float32)
    return base[:, :w].copy(), base[:, d_true:].copy()


def t(a):
    return torch.tensor(np.asarray(a))


def disparity_map(h, w, seed):
    """A 1/16-grid disparity map with flat regions, small speckles and
    invalid (0) pixels."""
    rng = np.random.default_rng(seed)
    d = np.repeat(np.repeat(rng.integers(5, 30, (h // 4 + 1, w // 4 + 1)), 4, 0), 4, 1)
    d = d[:h, :w].astype(np.float32)
    d += rng.integers(0, 16, (h, w)) / 16.0  # subpixel jitter within 1 px
    speck = rng.random((h, w)) < 0.03
    d[speck] = rng.integers(40, 60, speck.sum())  # isolated speckles
    d[rng.random((h, w)) < 0.05] = 0.0  # invalid pixels
    return d


def test_to_grayscale_exact():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (40, 200, 3)).astype(np.uint8)
    want = np.asarray(jcolor.to_grayscale(jnp.asarray(rgb)))
    got = color.to_grayscale(t(rgb)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_disp", [0, 3])
def test_bt_cost_volume_exact(min_disp):
    left, right = make_pair(24, 128, seed=2)
    want = np.asarray(jcosts.bt_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                            32, min_disp, 5, 31))
    got = costs.bt_cost_volume(t(left), t(right), 32, min_disp, 5, 31).numpy()
    np.testing.assert_array_equal(got, want)


# The geometry K1 is held to on the card: block sizes 1 to 11, caps 1 and
# 63, min_disp > 0, images of 1-3 rows and widths that are not multiples
# of 32, so every tap clamps at some edge.
@pytest.mark.parametrize(
    "h,w,num_disp,min_disp,block_size,cap",
    [(1, 45, 16, 0, 1, 31), (2, 70, 16, 3, 3, 1), (3, 33, 32, 0, 7, 63),
     (9, 50, 16, 5, 11, 63), (13, 97, 48, 2, 5, 1), (20, 75, 32, 0, 3, 63)],
)
def test_cost_volume_plain_edges_exact(h, w, num_disp, min_disp, block_size, cap):
    left, right = make_pair(h, w, seed=h + w)
    jcfg = jconfig.SGMConfig(num_disp=num_disp, min_disp=min_disp,
                             block_size=block_size, prefilter_cap=cap)
    cfg = config.config_from_dict(dataclasses.asdict(jcfg))
    want = np.asarray(jcosts.cost_volume(jnp.asarray(left), jnp.asarray(right), jcfg))
    got = cuda_sgm.cost_volume_plain(t(left), t(right), cfg)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int16))


def test_cost_volume_plain_fractional():
    """A smoothed (fractional) pair, like a rectified one: the pixel costs
    equal JAX's bit for bit, and the window adds them in _block_sum's
    order (rows top to bottom, then columns left to right, float32), which
    the kernel keeps. JAX's XLA reduce_window adds in another order, so
    a few int16 cells truncate the other way (ROADMAP Queue 3)."""
    h, w, d, min_disp = 24, 90, 32, 2
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (h, w + 7)).astype(np.float32)
    base = ((base + np.roll(base, 1, 0) * 0.7 + np.roll(base, 1, 1) * 0.3)
            / 2.1).astype(np.float32)
    left, right = base[:, :w].copy(), base[:, 7:].copy()
    jcfg = jconfig.SGMConfig(num_disp=d, min_disp=min_disp)
    cfg = config.config_from_dict(dataclasses.asdict(jcfg))
    pc = np.asarray(jcosts.bt_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                          d, min_disp, 1, cfg.prefilter_cap))
    np.testing.assert_array_equal(costs.bt_cost_volume(
        t(left), t(right), d, min_disp, 1, cfg.prefilter_cap).numpy(), pc)
    bs, r = cfg.block_size, cfg.block_size // 2
    ys = np.clip(np.arange(-r, h + r), 0, h - 1)
    xs = np.clip(np.arange(-r, w + r), 0, w - 1)
    rows = pc[ys[0:h]]
    for k in range(1, bs):
        rows = rows + pc[ys[k:k + h]]
    rows = rows[:, xs]
    ref = rows[:, 0:w]
    for k in range(1, bs):
        ref = ref + rows[:, k:k + w]
    got = cuda_sgm.cost_volume_plain(t(left), t(right), cfg).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int16))
    want = np.asarray(jcosts.cost_volume(jnp.asarray(left), jnp.asarray(right), jcfg))
    np.testing.assert_allclose(ref, want, rtol=0, atol=1e-3)
    assert (got == want.astype(np.int16)).mean() >= 0.995


@pytest.mark.parametrize("num_paths", [2, 3])
def test_aggregate_exact(num_paths):
    left, right = make_pair(24, 128, seed=3)
    c = np.asarray(jcosts.bt_cost_volume(jnp.asarray(left), jnp.asarray(right), 32))
    want = np.asarray(jsgm.aggregate(jnp.asarray(c), 200, 800, num_paths))
    got = sgm.aggregate(t(c), 200, 800, num_paths).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "min_disp,uniqueness_ratio,disp12_max_diff,dtype",
    [(0, 10, 1, np.int16), (3, 0, 1, np.int32), (0, 10, -1, np.int16),
     (0, 0, 0, np.float32)],
)
def test_wta_exact(min_disp, uniqueness_ratio, disp12_max_diff, dtype):
    rng = np.random.default_rng(4)
    h, w, d = 16, 96, 32
    s = rng.integers(100, 400, (h, w, d))
    # Planted ties: two equal minima (smallest d must win), and
    # equal-cost LR claimants.
    s[:, :, 7] = 50
    s[::2, :, 12] = 50
    s[:, ::3, 20] = 40
    s = s.astype(dtype)
    want = np.asarray(jwta.wta_disparity(jnp.asarray(s), min_disp,
                                         uniqueness_ratio, disp12_max_diff))
    got = wta.wta_disparity(t(s), min_disp, uniqueness_ratio, disp12_max_diff).numpy()
    np.testing.assert_array_equal(got, want)


def test_median3x3_exact():
    d = disparity_map(40, 200, seed=5)
    want = np.asarray(jfilters.median3x3(jnp.asarray(d)))
    np.testing.assert_array_equal(filters.median3x3(t(d)).numpy(), want)


@pytest.mark.parametrize("max_size,new_val", [(20, 0.0), (50, -1.0)])
def test_filter_speckles_exact(max_size, new_val):
    d = disparity_map(40, 200, seed=6)
    d[d == 0] = new_val
    # A mid-size blob (removed at 50, kept at 20) and a long thin one.
    d[10:15, 30:36] = 70.0
    d[30, 50:120] = 90.0
    want = np.asarray(jfilters.filter_speckles(jnp.asarray(d), new_val, max_size, 1.0))
    got = filters.filter_speckles(t(d), new_val, max_size, 1.0).numpy()
    assert (got != d).any()  # something was removed
    np.testing.assert_array_equal(got, want)


def test_detect_outliers():
    d = disparity_map(40, 200, seed=7)
    want = np.asarray(jfilters.detect_outliers(jnp.asarray(d), 2.5, 5))
    got = filters.detect_outliers(t(d), 2.5, 5).numpy()
    # Box sums in another order may flip a pixel sitting on the threshold;
    # allow at most 0.1 % of pixels.
    assert (got != want).mean() <= 1e-3
    assert want.any()


@pytest.mark.parametrize("method", ["inpaint", "nearest"])
def test_fill_holes(method):
    d = disparity_map(40, 200, seed=8)
    d[5:25, 60:100] = 0.0  # a large hole
    want = np.asarray(jfilters.fill_holes(jnp.asarray(d), method=method, kernel_size=3))
    got = filters.fill_holes(t(d), method=method, kernel_size=3).numpy()
    # Float means summed in another order: rounding-level differences.
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_wls_refine_and_temporal():
    d = disparity_map(40, 200, seed=9)
    rng = np.random.default_rng(9)
    guide = rng.integers(0, 256, d.shape).astype(np.float32)
    want = np.asarray(jwls.wls_refine(jnp.asarray(d), jnp.asarray(guide), 8, 100.0))
    got = wls.wls_refine(t(d), t(guide), 8, 100.0).numpy()
    # Float box sums and products in another order.
    np.testing.assert_allclose(got, want, rtol=1e-5)

    prev = d + rng.normal(0, 3, d.shape).astype(np.float32)
    want = np.asarray(jwls.temporal_smooth(jnp.asarray(d), jnp.asarray(prev), 0.4, 4.0))
    got = wls.temporal_smooth(t(d), t(prev), 0.4, 4.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("doffs,eps,max_depth", [(0.0, 0.0, None), (2.5, 3.0, 40.0)])
def test_disparity_to_depth(doffs, eps, max_depth):
    d = disparity_map(24, 64, seed=10)
    want = np.asarray(jdepth.disparity_to_depth(jnp.asarray(d), 700.0, 0.12, doffs,
                                                eps, max_depth))
    got = depth.disparity_to_depth(t(d), 700.0, 0.12, doffs, eps, max_depth).numpy()
    # Invalid pixels: +inf, or max_depth once clamped.
    assert (want == (np.inf if max_depth is None else max_depth)).any()
    # One float32 division each side; rtol covers a last-digit difference.
    np.testing.assert_allclose(got, want, rtol=1e-5)
