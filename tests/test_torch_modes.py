"""The PyTorch port's other SGM modes (hh4, sgbm, hh) and the census cost
against the JAX package on the CPU.

Inputs are integer-valued images made with a seeded numpy RNG and handed
to both packages, so every stage compared here is exact: integer costs
and integer path sums in float32 stay far below 2**24.

Census follows the JAX package's Pallas K1, which sums a block_size^2
window (pallas_sgm.py:105-106); its XLA route costs.cost_volume uses
block_size=1, so the census reference here is census_cost_volume(...,
cfg.block_size), not pipeline.raw_disparity.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu import config as jconfig
from depthestimation_tpu import pipeline as jpipeline
from depthestimation_tpu.ops import costs as jcosts
from depthestimation_tpu.ops import sgm as jsgm
from depthestimation_tpu.ops import wta as jwta
from depthestimation_torch import config, pipeline
from depthestimation_torch.ops import costs, cuda_sgm

H, W, D, SHIFT = 40, 200, 32, 7


def textured_pair(h, w, shift, seed):
    """Integer-valued float32 pair, left[x] == right[x - shift]."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    base = np.round((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0)
    return base[:, :w].copy(), base[:, shift:].copy()


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("mode", ["hh4", "sgbm", "hh"])
def test_raw_disparity_modes_exact(mode):
    left, right = textured_pair(H, W, SHIFT, seed=11)
    jcfg = jconfig.SGMConfig(num_disp=D, sgbm_mode=mode)
    cfg = config.config_from_dict(dataclasses.asdict(jcfg))
    cuda_sgm.check_supported(cfg, left.shape)
    want = np.asarray(jpipeline.raw_disparity(jnp.asarray(left),
                                              jnp.asarray(right), jcfg))
    got = pipeline.raw_disparity(t(left), t(right), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(want[:, D:] - SHIFT) <= 0.5).mean() > 0.9


@pytest.mark.parametrize("block_size,min_disp", [(5, 0), (3, 2)])
def test_census_cost_volume_exact(block_size, min_disp):
    left, right = textured_pair(H, W, SHIFT, seed=12)
    cfg = config.SGMConfig(num_disp=D, min_disp=min_disp, cost="census",
                           block_size=block_size)
    want = np.asarray(jcosts.census_cost_volume(
        jnp.asarray(left), jnp.asarray(right), D, min_disp, block_size))
    np.testing.assert_array_equal(
        costs.census_cost_volume(t(left), t(right), D, min_disp,
                                 block_size).numpy(), want)
    # The kernel's plain version: the cfg.block_size window, in int16.
    got = cuda_sgm.cost_volume(t(left), t(right), cfg)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int16))
    np.testing.assert_array_equal(
        costs.census_transform(t(left)).numpy(),
        np.asarray(jcosts._census_transform(jnp.asarray(left))))


# K1's census edge geometry: blocks 3 and 7, 2-11 rows, widths that are
# not multiples of 32, min_disp > 0.
@pytest.mark.parametrize("h,w,min_disp,block_size",
                         [(3, 45, 0, 3), (11, 70, 3, 7), (2, 37, 1, 7)])
def test_census_cost_volume_edges_exact(h, w, min_disp, block_size):
    left, right = textured_pair(h, w, SHIFT, seed=h + w)
    cfg = config.SGMConfig(num_disp=16, min_disp=min_disp, cost="census",
                           block_size=block_size)
    want = np.asarray(jcosts.census_cost_volume(
        jnp.asarray(left), jnp.asarray(right), 16, min_disp, block_size))
    got = cuda_sgm.cost_volume_plain(t(left), t(right), cfg)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int16))


def test_census_raw_disparity_exact():
    left, right = textured_pair(H, W, SHIFT, seed=13)
    cfg = config.SGMConfig(num_disp=D, cost="census", speckle_window_size=0)
    c = jcosts.census_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                  D, 0, cfg.block_size)
    want = np.asarray(jwta.wta_disparity(
        jsgm.aggregate(c, cfg.p1, cfg.p2, cfg.num_paths),
        cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff))
    got = pipeline.raw_disparity(t(left), t(right), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(want[:, D:] - SHIFT) <= 0.5).mean() > 0.9


@pytest.mark.parametrize(
    "dxs,reverse", [((0,), False), ((0,), True), ((0, 1, -1), False),
                    ((0, -1, 1), True)])
def test_rowsweep_plain_matches_aggregate_dir(dxs, reverse):
    rng = np.random.default_rng(14)
    cost = rng.integers(0, 300, (24, 60, 16)).astype(np.int16)
    acc = rng.integers(0, 2000, (24, 60, 16)).astype(np.int16)
    cfg = config.SGMConfig(num_disp=16)
    dy = -1 if reverse else 1
    want = acc.astype(np.float32)
    for dx in dxs:
        want = want + np.asarray(jsgm._aggregate_dir(
            jnp.asarray(cost, jnp.float32), dy, dx, float(cfg.p1),
            float(cfg.p2)))
    got = cuda_sgm.rowsweep(t(cost), t(acc), cfg, dxs, reverse, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
