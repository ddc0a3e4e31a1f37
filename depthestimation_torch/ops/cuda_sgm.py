"""The SGM matcher on hand-written CUDA kernels, with plain versions.

Counterpart of depthestimation_tpu/ops/pallas_sgm.py. The three kernels
(csrc/sgm_kernels.cu) work on the unpadded row-major (H, W, D) volume:

  K1 cost_volume  BT or census pixel cost + block_size^2 SAD window
                  -> int16 C
  K2 hscan        L->R scan (stores L), then R->L scan fused with the sum
                  -> S_we = L_lr + L_rl, in the _acc_dtype rule's type
  K3 rowsweep     row-direction scans (down or up, vertical or diagonal)
                  fused with the running sum -> S

followed by the WTA tail (ops/wta.py, plain torch). All four modes
compose these as the TPU matcher does (pallas_sgm.py:739-755); shapes
past the int16 bounds raise NotImplementedError (check_supported), and
pipeline.raw_disparity sends them down the float32 route instead, as the
JAX package does. Above 256 disparities K2 and K3 launch their wide
variants (one warp a line walking D in chunks of 256, the carry in a
scratch row), counted under their own names (hscan_wide,
rowsweep_wide[_diag][_up]); K1 tiles D on its grid at any size.

Each wrapper takes a tensor on the CPU through its plain version (the
same function in plain torch ops) and launches its kernel for a tensor on
the card; it never falls back. Each launch adds one to LAUNCHES[name],
each call on the card one to CALLS[name] (cuda_build, shared with the
remap kernel).

Storage dtypes are int16 whenever the worst-case magnitude k * bound of
the k directions summed into the stored tensor fits, as in the JAX
package (P1/P2: stereo_core.py:51-52).
"""

from __future__ import annotations

import torch

from . import costs, sgm, wta
from .cuda_build import (CALLS, LAUNCHES, called as _called, check as _check,
                         launched as _launched, load_library,
                         on_card as _on_card, reset_launches,
                         stream as _stream)

__all__ = [
    "LAUNCHES", "CALLS", "reset_launches", "kernels_supported", "check_supported",
    "cost_volume", "hscan", "hscan_launch", "rowsweep", "cost_volume_plain", "hscan_plain",
    "rowsweep_plain", "sgm_disparity", "sgm_disparity_plain",
]

# K2/K3 give each of a warp's 32 lanes at most 8 disparities; above this
# they launch their wide variants.
_NARROW_DISP = 256

# The row sweeps of each path count, as (dxs, reverse) per K3 pass
# (pallas_sgm.py:741-755): downward vertical, then for 4 paths upward
# vertical; 5 paths add both diagonals to the downward pass, 8 paths also
# run the mirrored upward pass.
_SWEEPS = {
    3: [((0,), False)],
    4: [((0,), False), ((0,), True)],
    5: [((0, 1, -1), False)],
    8: [((0, 1, -1), False), ((0, -1, 1), True)],
}


# ---------------------------------------------------------------------------
# dtype rules (pallas_sgm.py:100-155, same thresholds)
# ---------------------------------------------------------------------------


def _cmax(cfg) -> int:
    """Largest block cost. BT: per-pixel cost <= 2*prefilter_cap.
    Census: <= 24."""
    per_pixel = 24 if cfg.cost == "census" else 2 * cfg.prefilter_cap
    return cfg.block_size ** 2 * per_pixel


def _ldir_bound(cfg) -> int:
    """Worst-case per-direction aggregated cost (the TPU's bound, which
    covers its pad lanes too; kept so both packages store alike)."""
    return _cmax(cfg) + 3 * cfg.p2


def _stored_paths(cfg) -> int:
    """Directions summed into the largest intermediate stored partial sum."""
    return {3: 2, 4: 3, 5: 2, 8: 5}[cfg.num_paths]


def _acc_dtype(cfg) -> torch.dtype:
    if _stored_paths(cfg) * _ldir_bound(cfg) < 32600:
        return torch.int16
    return torch.int32


def _final_dtype(cfg) -> torch.dtype:
    """Storage dtype of the final aggregated volume S. A real lane's
    per-direction L is bounded by Cmax + P2, so int16 holds the sum of
    num_paths directions only when num_paths * (Cmax + P2) fits; it would
    wrap for e.g. block_size=7 'hh' (36 848) or block_size=11 sgbm_3way."""
    if cfg.num_paths * (_cmax(cfg) + cfg.p2) < 32600:
        return torch.int16
    return torch.int32


def kernels_supported(cfg, shape) -> bool:
    """True when the kernels' storage types and launch shapes hold cfg at
    an (h, w) image: the conditions of pallas_sgm.pallas_supported (its
    pad-lane cost is below _ldir_bound), at any num_disp."""
    if cfg.cost not in ("bt", "census"):
        return False
    if _ldir_bound(cfg) >= 32600:
        return False
    h, w = shape
    return w > cfg.num_disp + cfg.min_disp and h >= cfg.block_size


def check_supported(cfg, shape) -> None:
    """Raise NotImplementedError unless the kernels run cfg at shape."""
    if not kernels_supported(cfg, shape):
        raise NotImplementedError(
            f"cost={cfg.cost!r}, sgbm_mode={cfg.sgbm_mode!r}, "
            f"num_disp={cfg.num_disp}, min_disp={cfg.min_disp}, "
            f"block_size={cfg.block_size}, prefilter_cap={cfg.prefilter_cap} "
            f"on a {shape[0]}x{shape[1]} image is outside the kernels' "
            "int16 bounds or launch shapes"
        )


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def cost_volume_plain(left, right, cfg) -> torch.Tensor:
    """Plain version of K1: costs.cost_volume truncated to int16."""
    return costs.cost_volume(left, right, cfg).to(torch.int16)


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg) -> torch.Tensor:
    """K1: (H, W) float32 grayscale pair -> int16 (H, W, D) cost volume.

    One launch from the pair itself: the kernel computes the BT prefilter
    and its min/max envelopes, or the census words, in shared memory (the
    XLA ops around the TPU kernel, pallas_sgm.py:369-383), so no torch op
    runs before it."""
    if not _on_card(left):
        return cost_volume_plain(left, right, cfg)
    h, w = left.shape
    for t, what in ((left, "left"), (right, "right")):
        _check(t, what, torch.float32, (h, w), left.device)
    out = torch.empty((h, w, cfg.num_disp), dtype=torch.int16, device=left.device)
    lib = load_library()
    if cfg.cost == "census":
        name = "cost_volume_census"
        _launched(name, lib.sgm_census_cost_volume(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            h, w, cfg.num_disp, cfg.min_disp, cfg.block_size, _stream(),
        ))
    else:
        name = "cost_volume"
        _launched(name, lib.sgm_cost_volume(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            h, w, cfg.num_disp, cfg.min_disp, cfg.block_size,
            cfg.prefilter_cap, _stream(),
        ))
    _called(name)
    return out


def hscan_plain(cost, cfg) -> torch.Tensor:
    """Plain version of K2: the two horizontal directions of
    sgm.aggregate, in the _acc_dtype rule's type."""
    return sgm.aggregate(cost, cfg.p1, cfg.p2, 2).to(_acc_dtype(cfg))


def _wide(d) -> bool:
    """K2 and K3 launch their wide variants above 256 disparities."""
    return d > _NARROW_DISP


def _scratch(lines, d, device) -> torch.Tensor:
    """A wide scan's carry rows: 2 * (d + 16) int32 a line (the kernels'
    wide_cells), overwritten by the launch."""
    return torch.empty(lines * 2 * (d + 16), dtype=torch.int32, device=device)


def _hscan_name(d) -> str:
    """LAUNCHES key of K2: hscan, or hscan_wide above 256 disparities."""
    return "hscan_wide" if _wide(d) else "hscan"


def hscan(cost: torch.Tensor, cfg) -> torch.Tensor:
    """K2: int16 C (H, W, D) -> S_we = L_lr + L_rl. Two launches: the
    L->R scan stores L (int16), the R->L scan adds it."""
    if not _on_card(cost):
        return hscan_plain(cost, cfg)
    h, w, d = cost.shape
    _check(cost, "cost", torch.int16, (h, w, d), cost.device)
    l_lr = torch.empty_like(cost)
    hscan_launch(cost, None, l_lr, cfg)
    out = torch.empty((h, w, d), dtype=_acc_dtype(cfg), device=cost.device)
    hscan_launch(cost, l_lr, out, cfg)
    _called(_hscan_name(d))
    return out


def hscan_launch(cost: torch.Tensor, l_lr, out: torch.Tensor, cfg) -> None:
    """One of K2's two launches, on card tensors: with l_lr None the L->R
    scan of int16 cost into out (int16); else the R->L scan, added to l_lr
    and stored in out (int16 or int32). The wide variant above 256
    disparities."""
    h, w, d = cost.shape
    args = (cost.data_ptr(), None if l_lr is None else l_lr.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.int32), int(l_lr is not None), h, w, d, cfg.p1, cfg.p2)
    lib = load_library()
    if _wide(d):
        err = lib.sgm_hscan_wide(*args, _scratch(h, d, cost.device).data_ptr(), _stream())
    else:
        err = lib.sgm_hscan(*args, _stream())
    _launched(_hscan_name(d), err)


def _rowsweep_name(dxs, reverse, d) -> str:
    """LAUNCHES key of a K3 pass: rowsweep[_wide][_diag][_up], _wide above
    256 disparities."""
    return ("rowsweep" + ("_wide" if _wide(d) else "") + ("_diag" if any(dxs) else "")
            + ("_up" if reverse else ""))


def rowsweep_plain(cost, acc, cfg, dxs, reverse, out_dtype) -> torch.Tensor:
    """Plain version of K3: acc + the sum of sgm.aggregate_dir(cost, dy,
    dx) over dx in dxs, dy = -1 if reverse else +1, in out_dtype."""
    dy = -1 if reverse else 1
    c = cost.to(torch.float32)
    total = acc.to(torch.float32)
    for dx in dxs:
        total = total + sgm.aggregate_dir(c, dy, dx, float(cfg.p1),
                                          float(cfg.p2))
    return total.to(out_dtype)


def rowsweep(cost: torch.Tensor, acc: torch.Tensor, cfg, dxs, reverse: bool,
             out_dtype: torch.dtype) -> torch.Tensor:
    """K3: acc + the row-direction sweeps (dy = -1 if reverse else +1, one
    per dx in dxs) over int16 C, stored in out_dtype (the TPU signature,
    pallas_sgm.py:658). One launch per direction, each adding its L to the
    partial sum, which every launch stores in out_dtype.

    That is exact. Every per-direction L is >= 0: C >= 0, and the min(...)
    of the recurrence is >= min L', so L >= C. With acc >= 0 every partial
    sum acc + L_1 + ... + L_k therefore lies between 0 and the pass's final
    sum, which out_dtype holds by the _acc_dtype/_final_dtype rules. (Where
    a caller's out_dtype cannot hold the final sum, int16 partials keep the
    low 16 bits of the sum, as an int32 sum stored as int16 would.)"""
    if not _on_card(cost):
        return rowsweep_plain(cost, acc, cfg, dxs, reverse, out_dtype)
    lib = load_library()
    h, w, d = cost.shape
    _check(cost, "cost", torch.int16, (h, w, d), cost.device)
    if acc.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"acc has dtype {acc.dtype}, expected int16 or int32")
    _check(acc, "acc", acc.dtype, (h, w, d), cost.device)
    if out_dtype not in (torch.int16, torch.int32):
        raise TypeError(f"out_dtype {out_dtype} is not int16 or int32")
    if not dxs or any(dx not in (-1, 0, 1) for dx in dxs):
        raise ValueError(f"dxs must be a non-empty list of -1, 0, 1: {dxs}")
    name = _rowsweep_name(dxs, reverse, d)
    for dx in dxs:
        out = torch.empty((h, w, d), dtype=out_dtype, device=cost.device)
        args = (cost.data_ptr(), acc.data_ptr(), int(acc.dtype == torch.int32),
                out.data_ptr(), int(out_dtype == torch.int32), h, w, d,
                -1 if reverse else 1, dx, cfg.p1, cfg.p2)
        if _wide(d):
            lines = w if dx == 0 else w + h - 1
            err = lib.sgm_rowsweep_wide(*args, _scratch(lines, d, cost.device).data_ptr(),
                                        _stream())
        else:
            err = lib.sgm_rowsweep(*args, _stream())
        _launched(name, err)
        acc = out
    _called(name)
    return acc


# ---------------------------------------------------------------------------
# Orchestration (pallas_sgm.sgm_disparity)
# ---------------------------------------------------------------------------


def _matcher(left, right, cfg, cost_fn, hscan_fn, rowsweep_fn):
    check_supported(cfg, tuple(left.shape))
    left = left.to(torch.float32).contiguous()
    right = right.to(torch.float32).contiguous()
    c = cost_fn(left, right, cfg)
    s = hscan_fn(c, cfg)
    sweeps = _SWEEPS[cfg.num_paths]
    for i, (dxs, reverse) in enumerate(sweeps):
        dt = _final_dtype(cfg) if i == len(sweeps) - 1 else _acc_dtype(cfg)
        s = rowsweep_fn(c, s, cfg, dxs, reverse, dt)
    return wta.wta_disparity(s, cfg.min_disp, cfg.uniqueness_ratio,
                             cfg.disp12_max_diff)


def sgm_disparity(left: torch.Tensor, right: torch.Tensor, cfg) -> torch.Tensor:
    """Full matcher K1 -> K2 -> K3 -> WTA tail on an (H, W) grayscale pair:
    float32 (H, W) disparity on the 1/16 grid, invalid = min_disp - 1."""
    return _matcher(left, right, cfg, cost_volume, hscan, rowsweep)


def sgm_disparity_plain(left: torch.Tensor, right: torch.Tensor, cfg) -> torch.Tensor:
    """The same matcher composed of the kernels' plain versions, on any
    device (the reference the kernels are held to on the card)."""
    return _matcher(left, right, cfg, cost_volume_plain, hscan_plain,
                    rowsweep_plain)
