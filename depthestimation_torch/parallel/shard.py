"""Sharded stereo pipeline: frame data parallelism, row tiles with halo
exchange, and sharding over the disparity range (counterpart of
depthestimation_tpu/parallel/shard.py), on torch.distributed.

The SGM recurrence runs along each path, so with rows split over the
'tile' axis the vertical and diagonal scans need rows of the neighbouring
tiles. Each step renormalises by min_d' L, so a path's influence decays
with distance: a halo of rows swapped with the neighbours, computed again
and cropped, brings the tiled result close to the whole-image one.

The disparity-range split gives each rank D/n lanes of the (H, W, D) cost
volume: disp_sharded_blockmatch (local WTA, then the best over ranks) and
disp_sharded_sgm, the whole SGM matcher with its lane-coupled terms
(min_d', the d +- 1 neighbours at a rank's edge lanes, the WTA and
uniqueness minima) taken through collectives, equal bit for bit to the
single-device matcher.

JAX runs each of these as one program over the mesh (shard_map); here each
rank is a process. JAX's collectives become torch.distributed's: ppermute
a pair of batch_isend_irecv exchanges with the two neighbours along the
axis, pmin an all_reduce(MIN), all_gather all_gather. The calling
contracts are stated per function.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import SGMConfig
from ..ops import costs, sgm, wta
from ..pipeline import postprocess_and_depth, raw_disparity
from .mesh import axis_info

__all__ = [
    "tile_sharded_disparity",
    "tile_with_halo",
    "tile_disparity",
    "disp_sharded_blockmatch",
    "disp_sharded_sgm",
    "batch_pipeline",
    "DEFAULT_HALO",
]

DEFAULT_HALO = 64  # rows; SGM influence at this distance is < P2/halo ~ negligible


def _exchange(to_prev: torch.Tensor, to_next: torch.Tensor, group, index: int, n: int):
    """Swap with the neighbours along an axis of n ranks: send `to_prev`
    to rank index-1 and `to_next` to index+1. Returns (from_prev,
    from_next), what those neighbours sent towards this rank; None at the
    ends of the line (JAX's ppermute pair, shard.py:60-66)."""
    ops, from_prev, from_next = [], None, None
    if index > 0:
        peer = dist.get_global_rank(group, index - 1)
        from_prev = torch.empty_like(to_next)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if index < n - 1:
        peer = dist.get_global_rank(group, index + 1)
        from_next = torch.empty_like(to_prev)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_prev, from_next


def _halo_exchange_rows(x: torch.Tensor, halo: int, mesh, axis: str) -> torch.Tensor:
    """This rank's rows x (H_local, W[, C]) with `halo` rows of the
    previous tile prepended and `halo` rows of the next appended, swapped
    along `axis`. The first and last tiles repeat their own edge row (the
    whole-image pipeline's border)."""
    group, index, n = axis_info(mesh, axis)
    if halo > x.shape[0]:
        raise ValueError(f"halo {halo} exceeds the {x.shape[0]} rows of a tile")
    from_prev, from_next = _exchange(x[:halo], x[-halo:], group, index, n)
    if from_prev is None:
        from_prev = x[:1].expand(halo, *x.shape[1:])
    if from_next is None:
        from_next = x[-1:].expand(halo, *x.shape[1:])
    return torch.cat([from_prev, x, from_next], dim=0)


def _own_tile(x: torch.Tensor, index: int, n: int) -> torch.Tensor:
    """Rows of tile `index` of n of a whole image."""
    rows = x.shape[0] // n
    if rows * n != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} tiles")
    return x[index * rows:(index + 1) * rows]


def tile_with_halo(x: torch.Tensor, n_tiles: int, index: int, halo: int) -> torch.Tensor:
    """Tile `index` of n_tiles row tiles of a whole image x with its halo
    rows, as _halo_exchange_rows gives it to that tile's rank: lets one
    device run a tiled image tile by tile."""
    tile = _own_tile(x, index, n_tiles)
    if halo > tile.shape[0]:
        raise ValueError(f"halo {halo} exceeds the {tile.shape[0]} rows of a tile")
    lo, hi = index * tile.shape[0], (index + 1) * tile.shape[0]
    top = x[lo - halo:lo] if index > 0 else x[:1].expand(halo, *x.shape[1:])
    bottom = x[hi:hi + halo] if index < n_tiles - 1 else x[-1:].expand(halo, *x.shape[1:])
    return torch.cat([top, tile, bottom], dim=0)


def tile_disparity(left_h: torch.Tensor, right_h: torch.Tensor, cfg: SGMConfig,
                   halo: int) -> torch.Tensor:
    """The rank-local tile function: raw_disparity (the CUDA kernels on
    the card) of a tile with its halo rows, the halo cropped."""
    disp = raw_disparity(left_h, right_h, cfg)
    return disp[halo:disp.shape[0] - halo]


def _gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def tile_sharded_disparity(mesh, cfg: SGMConfig, halo: int = DEFAULT_HALO,
                           axis: str = "tile"):
    """A function (left, right) -> disparity with the rows split over
    `axis`. Contract: every rank passes the whole (H, W) float32 pair (H a
    multiple of the axis size) and gets the whole (H, W) disparity; each
    rank computes its tile with halo rows swapped with its neighbours
    (tile_disparity), and the tiles are gathered."""
    group, index, n = axis_info(mesh, axis)

    def fn(left, right):
        disp = tile_disparity(_halo_exchange_rows(_own_tile(left, index, n), halo, mesh, axis),
                              _halo_exchange_rows(_own_tile(right, index, n), halo, mesh, axis),
                              cfg, halo)
        return _gather_rows(disp, group, n)

    return fn


def _split_disparities(mesh, cfg: SGMConfig, axis: str):
    group, shard, n = axis_info(mesh, axis)
    if cfg.num_disp % n:
        raise ValueError(f"num_disp {cfg.num_disp} does not split over {n} ranks")
    return group, shard, n, cfg.num_disp // n


def disp_sharded_blockmatch(mesh, cfg: SGMConfig, axis: str = "model"):
    """Block matching with the disparity range split over `axis`: each
    rank builds its D/n planes of the BT cost volume, takes its local
    min/argmin, and the best over ranks wins (smallest d on ties). No SGM.

    Contract: every rank passes the whole (H, W) float32 pair and gets the
    whole (H, W) float32 integer disparity. A rank's planes come from the
    right image rolled by its first disparity; the roll's wrap lands in
    the left band the pipeline crops (as in JAX)."""
    group, shard, n, d_local = _split_disparities(mesh, cfg, axis)
    d0 = shard * d_local

    def fn(left, right):
        c = costs.bt_cost_volume(left, torch.roll(right, d0, dims=1), d_local,
                                 cfg.min_disp, cfg.block_size, cfg.prefilter_cap)
        local_min = c.amin(dim=-1)
        local_arg = c.argmin(dim=-1) + d0 + cfg.min_disp
        if n > 1:
            mins = [torch.empty_like(local_min) for _ in range(n)]
            args = [torch.empty_like(local_arg) for _ in range(n)]
            dist.all_gather(mins, local_min.contiguous(), group=group)
            dist.all_gather(args, local_arg.contiguous(), group=group)
            best = torch.stack(mins).argmin(dim=0)
            local_arg = torch.stack(args).gather(0, best[None])[0]
        return local_arg.to(torch.float32)

    return fn


def _shift_right_replicated(right: torch.Tensor, d0: int) -> torch.Tensor:
    """right_shifted[:, x] = right[:, max(x - d0, 0)]: the edge-replicated
    column shift that makes a shard's local cost volume equal lanes
    [d0, d0 + d_local) of the whole volume (costs._shift_right_stack
    clamps to column 0; a roll would wrap)."""
    x = torch.arange(right.shape[-1], device=right.device)
    return right[..., torch.clamp(x - d0, min=0)]


def disp_sharded_sgm(mesh, cfg: SGMConfig, axis: str = "model"):
    """The whole SGM matcher with the disparity range split over `axis`:
    every path direction of cfg's mode, WTA with uniqueness and subpixel,
    and the LR check, equal bit for bit to the single-device matcher
    (costs.bt_cost_volume -> sgm.aggregate -> wta.wta_disparity) on
    integer-valued images. The lane-coupled terms go through collectives:

      - min_d' L(p-r, d')  -> the local lane min, all_reduce(MIN);
      - L(p-r, d -/+ 1) at a rank's edge lanes -> one lane swapped with
        each neighbour, 1e9 at the ends of the line (global d = 0, D-1);
      - WTA min/argmin -> the packed int32 key s * D + d, all_reduce(MIN)
        (OpenCV's smallest-d tie-break over all ranks);
      - cm / cp / the uniqueness competitor -> masked local mins,
        all_reduce(MIN).

    Contract: every rank passes the whole (H, W) float32 pair and gets the
    whole (H, W) float32 disparity on the 1/16 grid (invalid = min_disp -
    1). The BT cost is the only cost (cfg.cost is not read), and the
    in-matcher speckle filter is not applied, as in JAX. One all_reduce
    and one lane swap per scan step: a 1080-row image makes thousands."""
    group, shard, n, d_local = _split_disparities(mesh, cfg, axis)
    d0, d_total = shard * d_local, cfg.num_disp
    p1, p2 = float(cfg.p1), float(cfg.p2)
    big, bigi = 1e9, 2**20

    def pmin(x):
        x = x.contiguous()
        if n > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
        return x

    def step(l_prev, c):
        """One SGM recurrence step on the local lanes (N, d_local)."""
        min_prev = pmin(l_prev.amin(dim=-1, keepdim=True))
        from_prev, from_next = _exchange(l_prev[..., :1], l_prev[..., -1:], group, shard, n)
        edge = torch.full_like(l_prev[..., :1], big)
        up = torch.cat([l_prev[..., 1:], edge if from_next is None else from_next], dim=-1)
        dn = torch.cat([edge if from_prev is None else from_prev, l_prev[..., :-1]], dim=-1)
        best = torch.minimum(torch.minimum(l_prev, torch.minimum(up, dn) + p1),
                             min_prev + p2)
        return c + best - min_prev

    def aggregate_dir(cost, dy, dx):
        h, w, _ = cost.shape
        out = torch.empty_like(cost)
        if dy == 0:
            l_prev = torch.zeros_like(cost[:, 0])
            for x in (range(w) if dx > 0 else range(w - 1, -1, -1)):
                l_prev = step(l_prev, cost[:, x])
                out[:, x] = l_prev
            return out
        l_prev = torch.zeros_like(cost[0])
        for y in (range(h) if dy > 0 else range(h - 1, -1, -1)):
            l_prev = step(sgm._shift_cols(l_prev, dx), cost[y])
            out[y] = l_prev
        return out

    def local_cost(left, right):
        """Lanes [d0, d0 + d_local) of the whole BT cost volume: the
        prefilter and envelopes on the true image columns first, then the
        right-side arrays shifted by d0 with edge replication (shifting the
        raw image would change the Sobel response at the seam)."""
        pl_ = costs.xsobel_prefilter(left, cfg.prefilter_cap)
        pr_ = costs.xsobel_prefilter(right, cfg.prefilter_cap)
        u0, u1 = costs.half_sample_envelope(pl_)
        v0, v1 = costs.half_sample_envelope(pr_)

        def stack(arr):
            return costs._shift_right_stack(_shift_right_replicated(arr, d0),
                                            cfg.min_disp, d_local)

        v, v0s, v1s = stack(pr_), stack(v0), stack(v1)
        u, u0e, u1e = pl_[:, :, None], u0[:, :, None], u1[:, :, None]
        c0 = torch.clamp(torch.maximum(u - v1s, v0s - u), min=0.0)
        c1 = torch.clamp(torch.maximum(v - u1e, u0e - v), min=0.0)
        return costs._block_sum(torch.minimum(c0, c1), cfg.block_size)

    def fn(left, right):
        c = local_cost(left.to(torch.float32), right.to(torch.float32))
        s = torch.zeros_like(c)
        for dy, dx in sgm.sgm_directions(cfg.num_paths):
            s = s + aggregate_dir(c, dy, dx)

        # ---- WTA over the global D axis (ops/wta.py semantics) ----
        s_i = torch.round(s).to(torch.int32)
        d_idx = d0 + torch.arange(d_local, dtype=torch.int32, device=s.device)
        m = pmin((s_i * d_total + d_idx).amin(dim=-1))
        min_s = m // d_total
        dsel = m - min_s * d_total
        fill = torch.full((), bigi, dtype=torch.int32, device=s.device)

        def masked_min(keep):
            return pmin(torch.where(keep, s_i, fill).amin(dim=-1))

        cm = masked_min(d_idx == dsel[..., None] - 1)
        cp = masked_min(d_idx == dsel[..., None] + 1)
        invalid = torch.zeros(dsel.shape, dtype=torch.bool, device=s.device)
        if cfg.uniqueness_ratio > 0:
            competitor = masked_min(torch.abs(d_idx - dsel[..., None]) > 1)
            invalid = competitor * (100 - cfg.uniqueness_ratio) < min_s * 100
        if cfg.disp12_max_diff >= 0:
            invalid = invalid | wta.lr_invalidate(dsel, min_s, ~invalid, cfg.disp12_max_diff,
                                                  cfg.min_disp, d_total)
        denom = torch.clamp(cm + cp - 2 * min_s, min=1)
        delta16 = torch.div((cm - cp) * 16 + denom, 2 * denom, rounding_mode="trunc")
        interior = (dsel > 0) & (dsel < d_total - 1)
        delta16 = torch.where(interior, delta16, 0)
        disp = ((cfg.min_disp + dsel) * 16 + delta16).to(torch.float32) / 16.0
        return torch.where(invalid, torch.full((), float(cfg.min_disp - 1), device=s.device),
                           disp)

    return fn


def batch_pipeline(mesh, cfg: SGMConfig, downscale_factor: float = 1.0,
                   fast_mode: bool = True, data_axis: str = "data",
                   tile_axis: Optional[str] = "tile", halo: int = DEFAULT_HALO):
    """The per-frame pipeline (raw_disparity, then postprocess_and_depth)
    over a batch of frames, frames split over `data_axis` and each frame's
    rows over `tile_axis` (None, or an axis of size 1, for whole frames).

    Contract: each rank passes its own frames, (B_local, H, W) float32
    rectified grayscale pairs, the same on every rank of its tile group,
    and gets their results: (disparity (B_local, H, W - num_disp), depth
    of that shape or None without focal length and baseline). Nothing
    crosses `data_axis`: which frames a rank holds is the caller's split,
    as in JAX's multi-process use. Frames run one after another (JAX's
    lax.map). With tiles, each rank runs its rows plus halo through the
    matcher and the post-processing, as JAX's shard_map does, and the
    tiles are gathered."""
    del data_axis  # no collective crosses it
    use_tile = tile_axis is not None and tile_axis in mesh.mesh_dim_names
    group, index, n = axis_info(mesh, tile_axis) if use_tile else (None, 0, 1)

    def per_frame(left, right):
        if n > 1:
            disp = tile_disparity(
                _halo_exchange_rows(_own_tile(left, index, n), halo, mesh, tile_axis),
                _halo_exchange_rows(_own_tile(right, index, n), halo, mesh, tile_axis),
                cfg, halo)
        else:
            disp = raw_disparity(left, right, cfg)
        disp, depth = postprocess_and_depth(disp, cfg, downscale_factor, fast_mode)
        return (_gather_rows(disp, group, n),
                None if depth is None else _gather_rows(depth, group, n))

    def run(lb, rb):
        out = [per_frame(l, r) for l, r in zip(lb, rb)]
        disp = torch.stack([d for d, _ in out])
        depth = None if out[0][1] is None else torch.stack([z for _, z in out])
        return disp, depth

    return run
