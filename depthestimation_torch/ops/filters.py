"""Disparity post-processing filters (plain PyTorch, and one CUDA kernel).

Counterparts of depthestimation_tpu/ops/filters.py, i.e. of the
reference's postprocess.py stages:

- median3x3:   cv2.medianBlur(..., 3) via a 9-element exchange network;
- box_mean:    cv2.boxFilter k x k mean (reflect-101 borders);
- detect_outliers: |d - mu| > k*sigma on valid (>0) pixels;
- filter_speckles: cv2.filterSpeckles; on the card a union-find labelling
  (csrc/speckle_kernels.cu), on the CPU filter_speckles_plain, min-label
  propagation plus a gather-free BFS-tree size count (the algorithm and
  its exactness argument are in the JAX module's docstring);
- fill_holes:  push-pull pyramid + masked Jacobi ('inpaint'), or the
  bounded nearest-valid dilation ('nearest');
- postprocess_disparity: the 4-step driver in reference order.

The loops that are `fori_loop`s in JAX are Python loops here.

filter_speckles takes a tensor on the CPU through filter_speckles_plain
and launches the kernel for a tensor on the card, for every shape and
window; it never falls back. Each call on the card adds its four launches
to LAUNCHES["speckle"] and one to CALLS["speckle"] (cuda_build).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_build import (called as _called, check as _check,
                         launched as _launched, load_library,
                         on_card as _on_card, stream as _stream)

__all__ = [
    "median3x3",
    "box_mean",
    "detect_outliers",
    "filter_speckles",
    "filter_speckles_plain",
    "fill_holes",
    "postprocess_disparity",
]

# The JAX module runs its propagation loops in rounds of this many steps;
# the step counts here match it.
_SPECKLE_UNROLL = 4


def _pad(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """Pad a 2-D tensor by r on every side ('replicate' or 'reflect')."""
    return F.pad(x[None], (r, r, r, r), mode=mode)[0]


def _shifted_planes_3x3(x: torch.Tensor):
    p = _pad(x, 1, "replicate")
    h, w = x.shape
    return [p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median via min/max exchange network (9 taps, border-replicated,
    matching cv2.medianBlur BORDER_REPLICATE)."""
    v = _shifted_planes_3x3(x.to(torch.float32))
    # Optimal 9-element median network (19 exchanges, Paeth).
    for i, j in [
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ]:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def box_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean with reflected borders (cv2.boxFilter default
    BORDER_REFLECT_101, normalize=True). Separable; each 1-D window is
    summed in ascending tap order."""
    r = k // 2
    p = _pad(x.to(torch.float32), r, "reflect")
    h = p.shape[0] - 2 * r
    w = p.shape[1] - 2 * r
    s = p[0:h]
    for i in range(1, k):
        s = s + p[i:i + h]
    t = s[:, 0:w]
    for i in range(1, k):
        t = t + s[:, i:i + w]
    # Divide by a tensor on t's device: for a host scalar divisor CUDA
    # multiplies by its reciprocal while the CPU (and XLA) divide, which
    # differs in the last bit on fractional input.
    return t / torch.full((), float(k * k), device=t.device)


def detect_outliers(disparity: torch.Tensor, threshold: float = 3.0, kernel_size: int = 5):
    """Local-statistics outlier mask (True = outlier), postprocess.py:37-70."""
    d = disparity.to(torch.float32)
    valid = d > 0
    mean = box_mean(d, kernel_size)
    mean_sq = box_mean(d * d, kernel_size)
    std = torch.sqrt(torch.clamp(mean_sq - mean * mean, min=0.0))
    return (torch.abs(d - mean) > threshold * std) & valid


def _nb(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = arr[y + dy, x + dx], or `fill` outside the map
    (|dy|, |dx| <= 1)."""
    h, w = arr.shape
    out = torch.full_like(arr, fill)
    out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = (
        arr[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    )
    return out


# Kernel launches in one call of csrc/speckle_kernels.cu's speckle_filter.
_SPECKLE_LAUNCHES = 4


def filter_speckles(
    disparity: torch.Tensor,
    new_val: float = 0.0,
    max_speckle_size: int = 100,
    max_diff: float = 1.0,
) -> torch.Tensor:
    """Remove small connected components from the (H, W) disparity map
    (cv2.filterSpeckles): filter_speckles_plain's semantics, bit for bit.
    On the card one call of the union-find kernel, whose labels and sizes
    are two int32 (H, W) planes of scratch."""
    if not _on_card(disparity):
        return filter_speckles_plain(disparity, new_val, max_speckle_size, max_diff)
    if disparity.ndim != 2:
        raise ValueError(f"disparity must be (H, W), not {tuple(disparity.shape)}")
    d = disparity.to(torch.float32).contiguous()
    _check(d, "disparity", torch.float32, d.shape, disparity.device)
    h, w = d.shape
    if h * w >= 2**31:
        raise ValueError(f"a {h}x{w} map has more pixels than int32 labels index")
    out = torch.empty_like(d)
    scratch = torch.empty((2, h, w), dtype=torch.int32, device=d.device)
    # Component sizes never pass h * w, so clamping keeps every verdict.
    max_size = min(max(int(max_speckle_size), -1), h * w)
    _launched("speckle", load_library().speckle_filter(
        d.data_ptr(), out.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        h, w, float(new_val), float(max_diff), max_size, _stream(),
    ), _SPECKLE_LAUNCHES)
    _called("speckle")
    return out


def filter_speckles_plain(
    disparity: torch.Tensor,
    new_val: float = 0.0,
    max_speckle_size: int = 100,
    max_diff: float = 1.0,
) -> torch.Tensor:
    """Remove small connected components from the disparity map.

    Semantics of cv2.filterSpeckles (postprocess.py:30): 4-connected
    components where neighboring disparities differ by <= max_diff; every
    component with <= max_speckle_size pixels is overwritten with new_val.
    Inputs are on the 1/16 grid, so every comparison is exact.

    Min-label flood fill, then a BFS distance field from each component
    root, parent pointers, a truncated subtree-count convergecast and a
    spread of the root's verdict -- all shifted-plane ops. Exact without
    global convergence; see depthestimation_tpu/ops/filters.py for the
    argument (label purity encoded as count poison).
    """
    d = disparity.to(torch.float32)
    h, w = d.shape
    n = h * w
    big = float(n)
    inf = float(n + 8)

    valid = d != new_val  # cv2 skips pixels already equal to newVal

    # Connectivity: |d(p) - d(q)| <= max_diff and both pixels valid.
    dirs = ((-1, 0), (1, 0), (0, -1), (0, 1))
    same = []
    for dy, dx in dirs:
        nd = _nb(d, dy, dx, float("inf"))
        nv = _nb(valid, dy, dx, False)
        same.append(valid & nv & (torch.abs(d - nd) <= max_diff))

    idx_map = torch.arange(n, dtype=torch.float32, device=d.device).reshape(h, w)
    labels = torch.where(valid, idx_map, big)

    # Enough steps for the worst removable component, a path of
    # max_speckle_size pixels whose labels move one pixel per step.
    s_max = int(max_speckle_size)
    steps = (s_max // _SPECKLE_UNROLL + 2) * _SPECKLE_UNROLL

    for _ in range(steps):
        out = labels
        for (dy, dx), s in zip(dirs, same):
            out = torch.minimum(out, torch.where(s, _nb(labels, dy, dx, big), big))
        labels = out

    # Same-label connectivity; a disagreeing edge poisons both endpoints.
    conn = []
    poison = torch.zeros((h, w), dtype=torch.bool, device=d.device)
    for (dy, dx), s in zip(dirs, same):
        agree = _nb(labels, dy, dx, big) == labels
        conn.append(s & agree)
        poison = poison | (s & ~agree)

    dist = torch.where(valid & (labels == idx_map), 0.0, inf)
    for _ in range(steps):
        best = torch.full_like(dist, inf)
        for k, (dy, dx) in enumerate(dirs):
            best = torch.minimum(best, torch.where(conn[k], _nb(dist, dy, dx, inf), inf))
        dist = torch.minimum(dist, best + 1.0)

    # Parent pointers: first direction whose same-label neighbor sits one
    # BFS level closer to the root (fixed N,S,W,E tie-break).
    parent = torch.full((h, w), -1.0, dtype=torch.float32, device=d.device)
    for k in range(3, -1, -1):
        dy, dx = dirs[k]
        ok = conn[k] & (_nb(dist, dy, dx, inf) == dist - 1.0)
        parent = torch.where(ok, float(k), parent)
    opp = (1.0, 0.0, 3.0, 2.0)
    child = [
        conn[k] & (_nb(parent, dy, dx, -1.0) == opp[k])
        for k, (dy, dx) in enumerate(dirs)
    ]

    seed = torch.where(poison, float(s_max + 2), 1.0)
    count = seed
    for _ in range(steps):
        total = seed
        for k, (dy, dx) in enumerate(dirs):
            total = total + torch.where(child[k], _nb(count, dy, dx, 0.0), 0.0)
        count = total

    # Removability is decided at the root, then spread back through the
    # component along same-label edges.
    rem = (dist == 0.0) & (count <= s_max)
    for _ in range(steps):
        for k, (dy, dx) in enumerate(dirs):
            rem = rem | (conn[k] & _nb(rem, dy, dx, False))
    return torch.where(rem, float(new_val), d)


def _masked_nearest_fill(x: torch.Tensor, hole: torch.Tensor, iters: int) -> torch.Tensor:
    """Iteratively pull the mean of known 3x3 neighbours into holes
    (reference 'nearest' fill: distance transform + repeated dilate,
    postprocess.py:106-116)."""
    f = torch.where(hole, 0.0, x)
    k = ~hole
    for _ in range(iters):
        planes_f = _shifted_planes_3x3(f)
        planes_k = _shifted_planes_3x3(k.to(torch.float32))
        acc = torch.zeros_like(f)
        cnt = torch.zeros_like(f)
        for pf, pk in zip(planes_f, planes_k):
            acc = acc + pf * pk
            cnt = cnt + pk
        avg = acc / torch.clamp(cnt, min=1.0)
        newly = (~k) & (cnt > 0)
        f = torch.where(newly, avg, f)
        k = k | newly
    return torch.where(hole, f, x)


def _push_pull_fill(x: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """Pyramid push-pull fill: every hole, however large, is seeded from
    its surrounding valid pixels via a masked-mean pyramid."""
    v = torch.where(hole, 0.0, x).to(torch.float32)
    m = (~hole).to(torch.float32)

    def pool2(a):
        return a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]

    def down(v, m):
        h, w = v.shape
        if h % 2 or w % 2:
            v = F.pad(v, (0, w % 2, 0, h % 2))
            m = F.pad(m, (0, w % 2, 0, h % 2))
        vs, ms = pool2(v), pool2(m)
        return vs / torch.clamp(ms, min=1.0), torch.clamp(ms, max=1.0)

    # Push: masked-mean pyramid down to 1x1.
    pyramid = [(v, m)]
    while max(pyramid[-1][0].shape) > 1:
        pyramid.append(down(*pyramid[-1]))

    # Pull: fill each level's holes from the coarser level (nearest up).
    vc, _ = pyramid[-1]
    for v_l, m_l in reversed(pyramid[:-1]):
        h, w = v_l.shape
        up = vc.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
        vc = torch.where(m_l > 0, v_l, up)
    return torch.where(hole, vc, x)


def fill_holes(
    disparity: torch.Tensor,
    mask: torch.Tensor | None = None,
    method: str = "inpaint",
    kernel_size: int = 5,
    diffusion_iters: int = 25,
) -> torch.Tensor:
    """Fill invalid regions of the disparity map (postprocess.py:72-118).

    'inpaint': push-pull seeding, then masked Jacobi diffusion of the
    4-neighbour Laplacian. 'nearest': the bounded dilate loop, scaled to
    the reference ellipse's reach (kernel_size * radius 3x3 rounds).
    """
    d = disparity.to(torch.float32)
    if mask is None:
        mask = d <= 0

    if method == "nearest":
        iters = kernel_size * max(kernel_size // 2, 1)
        return _masked_nearest_fill(d, mask, iters)

    f = _push_pull_fill(d, mask)
    # The JAX version runs diffusion_iters // 5 rounds of 5 steps.
    for _ in range(max(diffusion_iters // 5, 1) * 5):
        p = _pad(f, 1, "replicate")
        avg = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
        f = torch.where(mask, avg, f)
    return f


def postprocess_disparity(
    disparity: torch.Tensor,
    max_speckle_size: int = 50,
    max_diff: float = 1.0,
    outlier_threshold: float = 3.0,
    outlier_kernel: int = 5,
    fill_method: str = "inpaint",
    fill_kernel: int = 3,
    apply_outlier_removal: bool = True,
    apply_hole_filling: bool = True,
) -> torch.Tensor:
    """4-step refinement in reference order (postprocess.py:143-169):
    speckle filter -> outlier mask -> optional hole fill -> 3x3 median."""
    result = filter_speckles(
        disparity, 0.0, max_speckle_size=max_speckle_size, max_diff=max_diff
    )
    if apply_outlier_removal:
        outliers = detect_outliers(result, outlier_threshold, outlier_kernel)
        result = torch.where(outliers, 0.0, result)
    if apply_hole_filling:
        result = fill_holes(result, method=fill_method, kernel_size=fill_kernel)
    return median3x3(result)
