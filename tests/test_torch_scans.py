"""The plain versions of the scan kernels K2 (hscan) and K3 (rowsweep)
against the JAX package's per-direction aggregation on the CPU, at edge
geometry, and the argument that lets K3 store a pass's partial sums in the
pass's out dtype.

Inputs are integer costs made with a seeded numpy RNG and handed to both
packages; integer path sums in float32 stay far below 2**24, so every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.ops import sgm as jsgm
from depthestimation_torch import config
from depthestimation_torch.ops import cuda_sgm, sgm

# The K3 passes of the four modes, as (dxs, reverse).
SWEEPS = [((0,), False), ((0,), True), ((0, 1, -1), False), ((0, -1, 1), True)]


def jax_dir(cost, dy, dx, cfg):
    """JAX's L of one direction, as float64 numpy."""
    return np.asarray(jsgm._aggregate_dir(
        jnp.asarray(cost, jnp.float32), dy, dx, float(cfg.p1),
        float(cfg.p2))).astype(np.float64)


def random_cost(rng, cfg, shape):
    return rng.integers(0, cuda_sgm._cmax(cfg) + 1, shape).astype(np.int16)


# One row a little wider than D + min_disp; block size 5 stores S_we as
# int16, block size 11 as int32 (the _acc_dtype rule).
@pytest.mark.parametrize("d,min_disp,block_size,acc_dtype", [
    (16, 0, 5, torch.int16), (48, 3, 5, torch.int16),
    (16, 2, 11, torch.int32), (48, 0, 11, torch.int32)])
def test_hscan_plain_matches_jax(d, min_disp, block_size, acc_dtype):
    cfg = config.SGMConfig(num_disp=d, min_disp=min_disp, block_size=block_size)
    rng = np.random.default_rng(d + block_size)
    cost = random_cost(rng, cfg, (1, d + min_disp + 5, d))
    want = jax_dir(cost, 0, 1, cfg) + jax_dir(cost, 0, -1, cfg)
    got = cuda_sgm.hscan(torch.tensor(cost), cfg)
    assert got.dtype == acc_dtype == cuda_sgm._acc_dtype(cfg)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


# Tall and narrow (most diagonal lines enter from the side) and wide and
# short (most enter from the first row), with hh's storage types.
@pytest.mark.parametrize("dxs,reverse", SWEEPS)
@pytest.mark.parametrize("h,w", [(40, 5), (3, 50)])
def test_rowsweep_plain_tall_and_wide(h, w, dxs, reverse):
    cfg = config.SGMConfig(num_disp=16, sgbm_mode="hh")
    rng = np.random.default_rng(h * w + len(dxs) + reverse)
    cost = random_cost(rng, cfg, (h, w, 16))
    acc = rng.integers(0, 5000, (h, w, 16)).astype(np.int16)
    dy = -1 if reverse else 1
    want = acc.astype(np.float64)
    for dx in dxs:
        want = want + jax_dir(cost, dy, dx, cfg)
    out_dtype = cuda_sgm._final_dtype(cfg)
    got = cuda_sgm.rowsweep(torch.tensor(cost), torch.tensor(acc), cfg, dxs,
                            reverse, out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


@pytest.mark.parametrize("fill", ["cmax", "random"])
@pytest.mark.parametrize("mode", ["sgbm", "hh"])
def test_pass_partials_within_final(mode, fill):
    """K3 stores a pass's partial sums in the pass's out dtype. That is
    exact because every per-direction L >= C >= 0, so each partial sum lies
    between 0 and the pass's final sum, which the dtype rules size. Checked
    at every block size 1-17, each with the largest prefilter cap the
    kernels admit, at C = Cmax everywhere and at random costs."""
    h, w, d = 17, 24, 16  # h >= the largest block size the kernels take
    rng = np.random.default_rng(len(mode) + len(fill))
    for bs in range(1, 18, 2):
        cap = (32599 - 96 * bs * bs) // (2 * bs * bs)
        cfg = config.SGMConfig(num_disp=d, block_size=bs, prefilter_cap=cap,
                               sgbm_mode=mode)
        assert cuda_sgm.kernels_supported(cfg, (h, w))
        cmax = cuda_sgm._cmax(cfg)
        if fill == "cmax":
            cost = np.full((h, w, d), cmax, np.int16)
        else:
            cost = random_cost(rng, cfg, (h, w, d))
        c = torch.tensor(cost, dtype=torch.float32)
        dirs = lambda dy, dx: sgm.aggregate_dir(c, dy, dx, float(cfg.p1),
                                                float(cfg.p2)).double()
        acc_dt, final_dt = cuda_sgm._acc_dtype(cfg), cuda_sgm._final_dtype(cfg)
        total = dirs(0, 1) + dirs(0, -1)
        assert total.max() <= torch.iinfo(acc_dt).max
        passes = cuda_sgm._SWEEPS[cfg.num_paths]
        for i, (dxs, reverse) in enumerate(passes):
            out_dt = final_dt if i == len(passes) - 1 else acc_dt
            partials = [total]
            for dx in dxs:
                l_dir = dirs(-1 if reverse else 1, dx)
                assert (l_dir >= c.double()).all(), (bs, dx)
                partials.append(partials[-1] + l_dir)
            total = partials[-1]
            assert total.max() <= torch.iinfo(out_dt).max, (bs, i, out_dt)
            for p in partials[:-1]:
                assert (p >= 0).all() and (p <= total).all(), (bs, i)
