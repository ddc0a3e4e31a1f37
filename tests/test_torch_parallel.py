"""The port's sharded stereo pipeline (depthestimation_torch/parallel) on
four CPU processes joined over gloo, against the JAX package.

One launch of four ranks per module (tests/gloo_launch.py) runs every
multi-rank case: the halo exchange, tile_sharded_disparity at 4 tiles,
disp_sharded_sgm in sgbm_3way and hh and disp_sharded_blockmatch over 4
disparity shards, and batch_pipeline at data 2 x tile 2 and at data 4.
The ranks import torch and the port only; while they run, this process
computes JAX's results on the same inputs (JAX_PLATFORMS=cpu with the 8
virtual devices of conftest.py).

Every comparison is bit for bit. The pairs are integer-valued, as the
matcher needs for exactness: BT on fractional input sums its window in
another order in JAX's XLA route (ROADMAP Queue 3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.config import SGMConfig as JConfig
from depthestimation_tpu.ops import costs as jcosts
from depthestimation_tpu.ops import sgm as jsgm
from depthestimation_tpu.ops import wta as jwta
from depthestimation_tpu.parallel import shard as jshard
from depthestimation_tpu.parallel.mesh import make_mesh as jax_mesh
from depthestimation_torch.config import SGMConfig
from depthestimation_torch.parallel import shard
from depthestimation_torch.parallel.mesh import axis_info, make_mesh
from depthestimation_torch.pipeline import postprocess_and_depth, raw_disparity

import gloo_launch

H, W = 32, 80
LANES_HW = (16, 64)
TILE_HALO = 8

RANK_SCRIPT = r'''
import sys

import numpy as np
import torch
import torch.distributed as dist

from depthestimation_torch.config import SGMConfig
from depthestimation_torch.parallel import mesh as pm, shard

rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
pm.initialize_distributed(store, world, rank, device="cpu")
inp = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/inputs.npz").items()}
left, right = inp["left"], inp["right"]
out = {}

tiles = pm.make_mesh((1, 4, 1), device="cpu")
x = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
mine = shard._halo_exchange_rows(x[rank * 8:(rank + 1) * 8], 2, tiles, "tile")
parts = [torch.empty_like(mine) for _ in range(world)]
dist.all_gather(parts, mine)
out["halo"] = torch.stack(parts)
out["tiled"] = shard.tile_sharded_disparity(
    tiles, SGMConfig(num_disp=16), halo=int(inp["halo"]))(left, right)
left, right = inp["lanes_left"], inp["lanes_right"]

lanes = pm.make_mesh((1, 1, 4), device="cpu")
for mode in ("sgbm_3way", "hh"):
    cfg = SGMConfig(num_disp=32, sgbm_mode=mode, speckle_window_size=0)
    out["sgm_" + mode] = shard.disp_sharded_sgm(lanes, cfg)(left, right)
out["blockmatch"] = shard.disp_sharded_blockmatch(lanes, SGMConfig(num_disp=32))(left, right)
try:
    shard.disp_sharded_sgm(lanes, SGMConfig(num_disp=18))
    out["uneven_raises"] = torch.tensor(0)
except ValueError:
    out["uneven_raises"] = torch.tensor(1)

cfg = SGMConfig(num_disp=16, focal_length=100.0, baseline=0.1)
grid = pm.make_mesh((2, 2, 1), device="cpu")
_, d, _ = pm.axis_info(grid, "data")
own = slice(2 * d, 2 * d + 2)
run = shard.batch_pipeline(grid, cfg, fast_mode=True, halo=int(inp["halo"]))
out["batch_disp"], out["batch_depth"] = run(inp["frames_l"][own], inp["frames_r"][own])
whole = pm.make_mesh((4, 1, 1), device="cpu")
run = shard.batch_pipeline(whole, cfg, fast_mode=True, tile_axis=None)
own = slice(rank, rank + 1)
out["frame_disp"], out["frame_depth"] = run(inp["frames_l"][own], inp["frames_r"][own])

np.savez(f"{work}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
'''


def int_pair(h, w, d_true, seed):
    """A textured integer-valued pair with right[x] = left[x + d_true]."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + d_true)).astype(np.float32)
    base = np.round((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0)
    return base[:, :w], base[:, d_true:]


@pytest.fixture(scope="module")
def inputs():
    # The disparity-split pair: true disparity 8 in the top half and 15 in
    # the bottom; with 32 disparities over 4 ranks, the first lane of rank
    # 1 and its last, so the scans read lanes across ranks. Kept small:
    # every scan step is a collective (LANES_HW steps 2 W + H per pass).
    top = int_pair(LANES_HW[0] // 2, LANES_HW[1], 8, seed=4)
    bottom = int_pair(LANES_HW[0] // 2, LANES_HW[1], 15, seed=5)
    lanes_left, lanes_right = (np.concatenate(p) for p in zip(top, bottom))
    left, right = int_pair(H, W, 6, seed=4)
    frames = [int_pair(H, W, 5, seed=10 + i) for i in range(4)]
    return dict(left=left, right=right, lanes_left=lanes_left, lanes_right=lanes_right,
                halo=np.int64(TILE_HALO),
                frames_l=np.stack([f[0] for f in frames]),
                frames_r=np.stack([f[1] for f in frames]))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Start the four ranks; the first test that reads their results waits."""
    work = tmp_path_factory.mktemp("gloo_parallel")
    np.savez(work / "inputs.npz", **inputs)
    run = gloo_launch.start(RANK_SCRIPT, str(work))
    yield run
    run.close()


@pytest.fixture(scope="module")
def rank_out(ranks):
    ranks.wait()
    outs = [dict(np.load(os.path.join(ranks.workdir, f"rank{r}.npz"))) for r in range(4)]
    return outs


def test_every_rank_gets_the_global_result(rank_out):
    """Each global-in/global-out function gives every rank the same result."""
    for key in ("halo", "tiled", "sgm_sgbm_3way", "sgm_hh", "blockmatch"):
        for r in range(1, 4):
            np.testing.assert_array_equal(rank_out[r][key], rank_out[0][key], err_msg=key)


def test_halo_exchange_rows_roundtrip(rank_out):
    x = np.arange(32.0 * 4).reshape(32, 4)
    got = rank_out[0]["halo"]
    # Each tile of 8 rows becomes 12: [previous 2][own 8][next 2].
    assert got.shape == (4, 12, 4)
    np.testing.assert_array_equal(got[1, :2], x[6:8])
    np.testing.assert_array_equal(got[1, 2:10], x[8:16])
    np.testing.assert_array_equal(got[1, 10:], x[16:18])
    np.testing.assert_array_equal(got[0, :2], np.repeat(x[:1], 2, 0))  # edge replicated
    np.testing.assert_array_equal(got[3, 10:], np.repeat(x[-1:], 2, 0))
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], shard.tile_with_halo(torch.from_numpy(x), 4, i, 2).numpy())


def test_tile_sharded_matches_jax(inputs, rank_out):
    """4 row tiles with halo 8, bit-equal to JAX's at mesh (1, 4, 1), and
    to the rank-local tile function run tile by tile in one process."""
    left, right = inputs["left"], inputs["right"]
    fn = jax.jit(jshard.tile_sharded_disparity(
        jax_mesh((1, 4, 1)), JConfig(num_disp=16, use_pallas=False), halo=TILE_HALO))
    want = np.asarray(fn(jnp.asarray(left), jnp.asarray(right)))
    np.testing.assert_array_equal(rank_out[0]["tiled"], want)
    cfg = SGMConfig(num_disp=16)
    by_tile = torch.cat([
        shard.tile_disparity(shard.tile_with_halo(torch.from_numpy(left), 4, i, TILE_HALO),
                             shard.tile_with_halo(torch.from_numpy(right), 4, i, TILE_HALO),
                             cfg, TILE_HALO)
        for i in range(4)])
    np.testing.assert_array_equal(by_tile.numpy(), want)


@pytest.mark.parametrize("mode", ["sgbm_3way", "hh"])
def test_disp_sharded_sgm_exact(inputs, rank_out, mode):
    """Full SGM + WTA + LR over 4 disparity shards, bit-equal to JAX's
    single-device matcher (tests/test_sharding.py builds it so)."""
    cfg = JConfig(num_disp=32, sgbm_mode=mode, use_pallas=False, speckle_window_size=0)
    left, right = jnp.asarray(inputs["lanes_left"]), jnp.asarray(inputs["lanes_right"])
    c = jcosts.bt_cost_volume(left, right, cfg.num_disp, cfg.min_disp,
                              cfg.block_size, cfg.prefilter_cap)
    want = np.asarray(jwta.wta_disparity(
        jsgm.aggregate(c, cfg.p1, cfg.p2, cfg.num_paths),
        cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff))
    np.testing.assert_array_equal(rank_out[0]["sgm_" + mode], want)


def test_disp_sharded_blockmatch_matches_jax(inputs, rank_out):
    fn = jax.jit(jshard.disp_sharded_blockmatch(
        jax_mesh((1, 1, 4)), JConfig(num_disp=32, use_pallas=False), axis="model"))
    want = np.asarray(fn(jnp.asarray(inputs["lanes_left"]),
                         jnp.asarray(inputs["lanes_right"])))
    np.testing.assert_array_equal(rank_out[0]["blockmatch"], want)


def test_disparity_split_must_divide(rank_out):
    assert int(rank_out[0]["uneven_raises"]) == 1


def _single_pair(left, right, cfg):
    return postprocess_and_depth(raw_disparity(left, right, cfg), cfg, fast_mode=True)


@pytest.mark.parametrize("grid", ["data2_tile2", "data4"])
def test_batch_pipeline_per_frame(inputs, rank_out, grid):
    """Each rank's frames against the single-pair path on this process:
    at data 4 the whole frame, at data 2 x tile 2 each tile with its halo
    rows through raw_disparity and the fast post-processing, as JAX's
    shard_map runs a tile (bit for bit, disparity and depth)."""
    cfg = SGMConfig(num_disp=16, focal_length=100.0, baseline=0.1)
    frames = [(torch.from_numpy(a), torch.from_numpy(b))
              for a, b in zip(inputs["frames_l"], inputs["frames_r"])]
    for rank in range(4):
        if grid == "data4":
            got = rank_out[rank]["frame_disp"][0], rank_out[rank]["frame_depth"][0]
            want = _single_pair(*frames[rank], cfg)
            pairs = [(got, want)]
        else:
            own = frames[2 * (rank // 2): 2 * (rank // 2) + 2]
            pairs = []
            for k, (l, r) in enumerate(own):
                # tile_disparity's crop, then the post-processing of a tile.
                tiles = [postprocess_and_depth(
                    shard.tile_disparity(shard.tile_with_halo(l, 2, t, TILE_HALO),
                                         shard.tile_with_halo(r, 2, t, TILE_HALO),
                                         cfg, TILE_HALO), cfg, fast_mode=True)
                         for t in range(2)]
                want = (torch.cat([d for d, _ in tiles]), torch.cat([z for _, z in tiles]))
                got = rank_out[rank]["batch_disp"][k], rank_out[rank]["batch_depth"][k]
                pairs.append((got, want))
        for (gd, gz), (wd, wz) in pairs:
            assert gd.shape == (H, W - 16)
            np.testing.assert_array_equal(gd, wd.numpy())
            np.testing.assert_array_equal(gz, wz.numpy())


def test_one_rank_mesh_starts_its_own_group():
    """A one-rank mesh needs no launcher; its functions run every stage on
    this process (the collectives degenerate)."""
    mesh = make_mesh((1, 1, 1), device="cpu")
    try:
        assert [axis_info(mesh, a)[1:] for a in ("data", "tile", "model")] == [(0, 1)] * 3
        left, right = (torch.from_numpy(a) for a in int_pair(H, W, 6, seed=4))
        cfg = SGMConfig(num_disp=16, sgbm_mode="sgbm_3way", speckle_window_size=0)
        np.testing.assert_array_equal(shard.disp_sharded_sgm(mesh, cfg)(left, right).numpy(),
                                      raw_disparity(left, right, cfg).numpy())
        with pytest.raises(ValueError, match="ranks"):
            make_mesh((2, 1, 1), device="cpu")
    finally:
        torch.distributed.destroy_process_group()
