"""The SGM matcher on hand-written CUDA kernels, with plain versions.

Counterpart of depthestimation_tpu/ops/pallas_sgm.py. The three kernels
(csrc/sgm_kernels.cu) work on the unpadded row-major (H, W, D) volume:

  K1 cost_volume  BT pixel cost + block_size^2 SAD window -> int16 C
  K2 hscan        L->R scan (stores L), then R->L scan fused with the sum
                  -> S_we = L_lr + L_rl, in the _acc_dtype rule's type
  K3 rowsweep     downward vertical scan fused with the final sum
                  -> S = S_we + L_down, in the _final_dtype rule's type

followed by the WTA tail (ops/wta.py, plain torch). This is the sgbm_3way
path with the BT cost; other modes, census and shapes past the int16
bounds raise NotImplementedError (check_supported).

Each wrapper takes a tensor on the CPU through its plain version (the
same function in plain torch ops) and launches its kernel for a tensor on
the card; it never falls back. Each launch adds one to LAUNCHES[name].

Storage dtypes are int16 whenever the worst-case magnitude k * bound of
the k directions summed into the stored tensor fits, as in the JAX
package (P1/P2: stereo_core.py:51-52).
"""

from __future__ import annotations

import torch

from . import costs, sgm, wta

__all__ = [
    "LAUNCHES", "reset_launches", "kernels_supported", "check_supported",
    "cost_volume", "hscan", "rowsweep", "cost_volume_plain", "hscan_plain",
    "rowsweep_plain", "sgm_disparity", "sgm_disparity_plain",
]

# Launch counts per kernel wrapper; K2 launches twice per call.
LAUNCHES = {"cost_volume": 0, "hscan": 0, "rowsweep": 0}

# K2/K3 give each of a warp's 32 lanes at most 8 disparities.
_MAX_DISP = 256

_NEXT_SLICE = ("the slice that ports the other SGM modes and the census "
               "cost (see ROADMAP.md)")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    pad-lane cost is below _ldir_bound) plus num_disp <= 256."""
    if cfg.cost not in ("bt", "census"):
        return False
    if _ldir_bound(cfg) >= 32600:
        return False
    h, w = shape
    if w <= cfg.num_disp + cfg.min_disp or h < cfg.block_size:
        return False
    return cfg.num_disp <= _MAX_DISP


def check_supported(cfg, shape) -> None:
    """Raise NotImplementedError unless this slice's matcher runs cfg."""
    if cfg.cost != "bt":
        raise NotImplementedError(
            f"cost={cfg.cost!r} is not ported yet; it comes with {_NEXT_SLICE}"
        )
    if cfg.sgbm_mode != "sgbm_3way":
        raise NotImplementedError(
            f"sgbm_mode={cfg.sgbm_mode!r} is not ported yet; it comes with "
            f"{_NEXT_SLICE}"
        )
    if not kernels_supported(cfg, shape):
        raise NotImplementedError(
            f"num_disp={cfg.num_disp}, min_disp={cfg.min_disp}, "
            f"block_size={cfg.block_size}, prefilter_cap={cfg.prefilter_cap} "
            f"on a {shape[0]}x{shape[1]} image is outside the kernels' "
            "int16 bounds or launch shapes"
        )


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def cost_volume_plain(left, right, cfg) -> torch.Tensor:
    """Plain version of K1: costs.bt_cost_volume truncated to int16."""
    return costs.bt_cost_volume(
        left, right, cfg.num_disp, cfg.min_disp, cfg.block_size,
        cfg.prefilter_cap,
    ).to(torch.int16)


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg) -> torch.Tensor:
    """K1: (H, W) float32 grayscale pair -> int16 (H, W, D) cost volume.

    The prefilter and its min/max envelopes are plain torch ops, as they
    are XLA ops around the TPU kernel (pallas_sgm.py:380-383)."""
    if not _on_card(left):
        return cost_volume_plain(left, right, cfg)
    from .cuda_build import load_library

    h, w = left.shape
    for t, what in ((left, "left"), (right, "right")):
        _check(t, what, torch.float32, (h, w), left.device)
    pl_ = costs.xsobel_prefilter(left, cfg.prefilter_cap)
    pr = costs.xsobel_prefilter(right, cfg.prefilter_cap)
    planes = [pl_, *costs.half_sample_envelope(pl_),
              pr, *costs.half_sample_envelope(pr)]
    out = torch.empty((h, w, cfg.num_disp), dtype=torch.int16, device=left.device)
    err = load_library().sgm_cost_volume(
        *(p.data_ptr() for p in planes), out.data_ptr(),
        h, w, cfg.num_disp, cfg.min_disp, cfg.block_size, _stream(),
    )
    _launched("cost_volume", err)
    return out


def hscan_plain(cost, cfg) -> torch.Tensor:
    """Plain version of K2: the two horizontal directions of
    sgm.aggregate, in the _acc_dtype rule's type."""
    return sgm.aggregate(cost, cfg.p1, cfg.p2, 2).to(_acc_dtype(cfg))


def hscan(cost: torch.Tensor, cfg) -> torch.Tensor:
    """K2: int16 C (H, W, D) -> S_we = L_lr + L_rl. Two launches: the
    L->R scan stores L (int16), the R->L scan adds it."""
    if not _on_card(cost):
        return hscan_plain(cost, cfg)
    from .cuda_build import load_library

    lib = load_library()
    h, w, d = cost.shape
    _check(cost, "cost", torch.int16, (h, w, d), cost.device)
    acc_dt = _acc_dtype(cfg)
    l_lr = torch.empty_like(cost)
    _launched("hscan", lib.sgm_hscan(
        cost.data_ptr(), None, l_lr.data_ptr(), 0, 0, h, w, d,
        cfg.p1, cfg.p2, _stream(),
    ))
    out = torch.empty((h, w, d), dtype=acc_dt, device=cost.device)
    _launched("hscan", lib.sgm_hscan(
        cost.data_ptr(), l_lr.data_ptr(), out.data_ptr(),
        int(acc_dt == torch.int32), 1, h, w, d, cfg.p1, cfg.p2, _stream(),
    ))
    return out


def rowsweep_plain(cost, acc, cfg) -> torch.Tensor:
    """Plain version of K3: acc + the downward vertical direction of
    sgm.aggregate, in the _final_dtype rule's type."""
    down = sgm.aggregate_dir(cost.to(torch.float32), 1, 0,
                             float(cfg.p1), float(cfg.p2))
    return (acc.to(torch.float32) + down).to(_final_dtype(cfg))


def rowsweep(cost: torch.Tensor, acc: torch.Tensor, cfg) -> torch.Tensor:
    """K3: S = acc + L_down, the downward vertical scan over int16 C."""
    if not _on_card(cost):
        return rowsweep_plain(cost, acc, cfg)
    from .cuda_build import load_library

    h, w, d = cost.shape
    _check(cost, "cost", torch.int16, (h, w, d), cost.device)
    _check(acc, "acc", _acc_dtype(cfg), (h, w, d), cost.device)
    final_dt = _final_dtype(cfg)
    out = torch.empty((h, w, d), dtype=final_dt, device=cost.device)
    _launched("rowsweep", load_library().sgm_rowsweep(
        cost.data_ptr(), acc.data_ptr(), int(acc.dtype == torch.int32),
        out.data_ptr(), int(final_dt == torch.int32), h, w, d,
        cfg.p1, cfg.p2, _stream(),
    ))
    return out


# ---------------------------------------------------------------------------
# Orchestration (pallas_sgm.sgm_disparity, sgbm_3way)
# ---------------------------------------------------------------------------


def _matcher(left, right, cfg, cost_fn, hscan_fn, rowsweep_fn):
    check_supported(cfg, tuple(left.shape))
    left = left.to(torch.float32).contiguous()
    right = right.to(torch.float32).contiguous()
    c = cost_fn(left, right, cfg)
    s = rowsweep_fn(c, hscan_fn(c, cfg), cfg)
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
