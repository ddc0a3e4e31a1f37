"""Semi-global matching path aggregation (plain PyTorch).

Counterpart of depthestimation_tpu/ops/sgm.py (OpenCV computeDisparitySGBM,
reference stereo_core.py:63-75). Per path direction r the recurrence is

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_d' L_r(p-r, d') + P2 ) - min_d' L_r(p-r, d')

with P1 = 8*bs^2, P2 = 32*bs^2 (stereo_core.py:51-52). The scan is a
Python loop over the path axis; each step is a (rows x D) or (cols x D)
plane. This module stays generic over path counts: it is the semantics
reference and the plain version of the horizontal-scan and row-sweep
kernels in ops/cuda_sgm.py.

Path topologies (config._MODE_TO_PATHS):
  3-way: L->R, R->L, T->B                       ('sgbm_3way')
  4:     + B->T                                  ('hh4')
  5:     + TL->BR                                ('sgbm')
  8:     + BR->TL, TR->BL, BL->TR                ('hh')
"""

from __future__ import annotations

import torch

__all__ = ["aggregate", "aggregate_dir", "sgm_directions"]

# (dy, dx) propagation directions for each path count.
_PATHS = {
    1: [(0, 1)],
    2: [(0, 1), (0, -1)],
    3: [(0, 1), (0, -1), (1, 0)],
    4: [(0, 1), (0, -1), (1, 0), (-1, 0)],
    5: [(0, 1), (0, -1), (1, 0), (1, 1), (1, -1)],
    8: [
        (0, 1),
        (0, -1),
        (1, 0),
        (-1, 0),
        (1, 1),
        (-1, -1),
        (1, -1),
        (-1, 1),
    ],
}

# Stands in for the out-of-range d-1 / d+1 neighbour; far above any cost.
_BIG = 1e9


def sgm_directions(num_paths: int):
    return _PATHS[num_paths]


def _step(l_prev: torch.Tensor, c: torch.Tensor, p1: float, p2: float):
    # l_prev, c: (N, D)
    min_prev = l_prev.min(dim=-1, keepdim=True).values
    edge = torch.full_like(l_prev[..., :1], _BIG)
    up = torch.cat([l_prev[..., 1:], edge], dim=-1)
    dn = torch.cat([edge, l_prev[..., :-1]], dim=-1)
    best = torch.minimum(
        torch.minimum(l_prev, torch.minimum(up, dn) + p1), min_prev + p2
    )
    return c + best - min_prev


def _shift_cols(x: torch.Tensor, dx: int) -> torch.Tensor:
    """Shift the column axis of an (N_cols, D) carry by dx, zero-filling the
    vacated edge (a zero carry row acts as 'no predecessor': L = C)."""
    if dx == 0:
        return x
    if dx > 0:
        return torch.cat([torch.zeros_like(x[:dx]), x[:-dx]], dim=0)
    return torch.cat([x[-dx:], torch.zeros_like(x[:-dx])], dim=0)


def aggregate_dir(cost: torch.Tensor, dy: int, dx: int, p1: float, p2: float):
    """Aggregate one direction over cost (H, W, D) float32 -> L (H, W, D)."""
    h, w, _ = cost.shape
    out = torch.empty_like(cost)
    if dy == 0:
        # Horizontal: scan over W; carry is (H, D).
        l_prev = torch.zeros_like(cost[:, 0])
        for x in (range(w) if dx > 0 else range(w - 1, -1, -1)):
            l_prev = _step(l_prev, cost[:, x], p1, p2)
            out[:, x] = l_prev
        return out
    # Vertical / diagonal: scan over H; the carry (W, D) holds row y-dy and
    # is shifted by dx (predecessor of (y, x) is (y-dy, x-dx)).
    l_prev = torch.zeros_like(cost[0])
    for y in (range(h) if dy > 0 else range(h - 1, -1, -1)):
        l_prev = _step(_shift_cols(l_prev, dx), cost[y], p1, p2)
        out[y] = l_prev
    return out


def aggregate(cost: torch.Tensor, p1: float, p2: float, num_paths: int = 4) -> torch.Tensor:
    """Sum of per-direction aggregated costs S = sum_r L_r, (H, W, D) float32.

    Exact on integer costs: every value stays far below 2**24."""
    cost = cost.to(torch.float32)
    s = torch.zeros_like(cost)
    for dy, dx in _PATHS[num_paths]:
        s = s + aggregate_dir(cost, dy, dx, float(p1), float(p2))
    return s
