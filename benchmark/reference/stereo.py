"""Plain reference of the stereo pipeline: uint8 RGB pair in, disparity
and depth out, in plain PyTorch on any device.

Frozen from the plain versions of the port's stages, so that a change to
the program cannot move it; it imports nothing of the program:
grayscale (BT.601, rounded), the BT cost on x-Sobel prefiltered images
with a block_size^2 SAD window, SGM path aggregation stored as the
kernels store it (int16 where the worst case fits), winner-take-all with
uniqueness, OpenCV's 1/16 subpixel and the left-right check, the
in-matcher speckle filter, the left-band crop, the full postprocess (or
the 3x3 median in fast mode), the WLS-style guided filter and
disparity-to-depth.

Every stage after the matcher's integer winner-take-all computes in
`dt`: float32 is the reference; a lower type gives the control that the
comparison has to fail. The speckle filter's component labels are pixel
indices and stay float32 whatever `dt` is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["check_supported", "stereo_depth"]

_BT601 = (0.299, 0.587, 0.114)
_PATHS = {
    3: [(0, 1), (0, -1), (1, 0)],
    4: [(0, 1), (0, -1), (1, 0), (-1, 0)],
    5: [(0, 1), (0, -1), (1, 0), (1, 1), (1, -1)],
    8: [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1), (-1, 1)],
}
_MODE_PATHS = {"sgbm": 5, "hh": 8, "sgbm_3way": 3, "hh4": 4}
# K3's passes: (dxs, reverse) per pass, after K2's two horizontal paths.
_SWEEPS = {3: [((0,), False)], 4: [((0,), False), ((0,), True)],
           5: [((0, 1, -1), False)], 8: [((0, 1, -1), False), ((0, -1, 1), True)]}
_BIG_L = 1e9        # out-of-range d +- 1 neighbour in a scan step
_BIG_KEY = 2 ** 20  # "no claimant" in the LR check
_SPECKLE_UNROLL = 4


def check_supported(sgm: dict) -> None:
    """Raise ValueError for a setting this reference does not compute."""
    if sgm["cost"] != "bt":
        raise ValueError("the stereo reference computes the BT cost only")
    if sgm.get("temporal_alpha", 0.0) > 0:
        raise ValueError("the stereo reference has no temporal smoother")
    if _stored_dtype(sgm, final=True) != torch.int16 or sgm["num_disp"] > 256:
        raise ValueError("the stereo reference follows the int16 kernels only")


# ---------------------------------------------------------------- helpers

def _pad(x, r, mode):
    return F.pad(x[None], (r, r, r, r), mode=mode)[0]


def _pad_edge(img, top, bottom, left, right):
    return F.pad(img[None], (left, right, top, bottom), mode="replicate")[0]


def _const(v, like):
    """A scalar on like's device in like's type: CUDA multiplies by the
    reciprocal of a host scalar divisor, the CPU divides."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> float32 grayscale, rounded like cv2."""
    f = img.to(torch.float32)
    g = (f[..., 0] * _BT601[0] + f[..., 1] * _BT601[1]) + f[..., 2] * _BT601[2]
    return torch.round(g).to(img.dtype).to(torch.float32)


# ---------------------------------------------------------------- cost

def _xsobel(img, cap):
    p = _pad_edge(img, 1, 1, 1, 1)
    dx = ((p[:-2, 2:] - p[:-2, :-2]) + 2.0 * (p[1:-1, 2:] - p[1:-1, :-2])
          + (p[2:, 2:] - p[2:, :-2]))
    return torch.clamp(dx, -cap, cap) + cap


def _envelope(img):
    left = _pad_edge(img, 0, 0, 1, 0)[:, :-1]
    right = _pad_edge(img, 0, 0, 0, 1)[:, 1:]
    hl, hr = torch.floor(0.5 * (img + left)), torch.floor(0.5 * (img + right))
    return (torch.minimum(img, torch.minimum(hl, hr)),
            torch.maximum(img, torch.maximum(hl, hr)))


def _shifted(arr, min_disp, num_disp):
    w = arr.shape[1]
    x = torch.arange(w, device=arr.device)[:, None]
    d = torch.arange(num_disp, device=arr.device)[None, :] + min_disp
    return arr[:, torch.clamp(x - d, 0, w - 1)]


def _block_sum(vol, bs):
    if bs <= 1:
        return vol
    r = bs // 2
    h, w, _ = vol.shape
    ys = torch.clamp(torch.arange(-r, h + r, device=vol.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-r, w + r, device=vol.device), 0, w - 1)
    padded = vol[ys]
    rows = padded[0:h]
    for k in range(1, bs):
        rows = rows + padded[k:k + h]
    rows = rows[:, xs]
    out = rows[:, 0:w]
    for k in range(1, bs):
        out = out + rows[:, k:k + w]
    return out


def cost_volume(left, right, sgm) -> torch.Tensor:
    """BT cost (H, W, D), int16 as the kernels store it."""
    d, md = sgm["num_disp"], sgm["min_disp"]
    pl, pr = _xsobel(left, sgm["prefilter_cap"]), _xsobel(right, sgm["prefilter_cap"])
    umin, umax = _envelope(pl)
    vmin, vmax = _envelope(pr)
    v, v0, v1 = (_shifted(a, md, d) for a in (pr, vmin, vmax))
    u, u0, u1 = pl[:, :, None], umin[:, :, None], umax[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=left.device)
    c0 = torch.maximum(torch.maximum(u - v1, v0 - u), zero)
    c1 = torch.maximum(torch.maximum(v - u1, u0 - v), zero)
    return _block_sum(torch.minimum(c0, c1), sgm["block_size"]).to(torch.int16)


# ---------------------------------------------------------------- SGM

def _step(l_prev, c, p1, p2):
    min_prev = l_prev.min(dim=-1, keepdim=True).values
    edge = torch.full_like(l_prev[..., :1], _BIG_L)
    up = torch.cat([l_prev[..., 1:], edge], dim=-1)
    dn = torch.cat([edge, l_prev[..., :-1]], dim=-1)
    best = torch.minimum(torch.minimum(l_prev, torch.minimum(up, dn) + p1), min_prev + p2)
    return c + best - min_prev


def _horizontal_pair(cost, p1, p2):
    """L_lr + L_rl: both horizontal paths scanned in one loop, the
    right-to-left one on the column-reversed volume."""
    h, w, _ = cost.shape
    both = torch.cat([cost, cost.flip(1)], dim=0)  # (2H, W, D)
    out = torch.empty_like(both)
    carry = torch.zeros_like(both[:, 0])
    for x in range(w):
        carry = _step(carry, both[:, x], p1, p2)
        out[:, x] = carry
    return out[:h] + out[h:].flip(1)


def _shift_cols(x, dx):
    if dx == 0:
        return x
    if dx > 0:
        return torch.cat([torch.zeros_like(x[:dx]), x[:-dx]], dim=0)
    return torch.cat([x[-dx:], torch.zeros_like(x[:-dx])], dim=0)


def _rows(cost, dy, dx, p1, p2):
    h = cost.shape[0]
    out = torch.empty_like(cost)
    carry = torch.zeros_like(cost[0])
    for y in (range(h) if dy > 0 else range(h - 1, -1, -1)):
        carry = _step(_shift_cols(carry, dx), cost[y], p1, p2)
        out[y] = carry
    return out


def _stored_dtype(sgm, final):
    bs = sgm["block_size"]
    cmax = bs * bs * 2 * sgm["prefilter_cap"]
    p2 = 32 * bs * bs
    paths = _MODE_PATHS[sgm["sgbm_mode"]]
    if final:
        return torch.int16 if paths * (cmax + p2) < 32600 else torch.int32
    stored = {3: 2, 4: 3, 5: 2, 8: 5}[paths]
    return torch.int16 if stored * (cmax + 3 * p2) < 32600 else torch.int32


def aggregate(c, sgm) -> torch.Tensor:
    """S = sum over the mode's paths of L_r, stored as the kernels store
    each partial sum. Exact: every value is an integer far below 2**24."""
    bs = sgm["block_size"]
    p1, p2 = float(8 * bs * bs), float(32 * bs * bs)
    cf = c.to(torch.float32)
    s = _horizontal_pair(cf, p1, p2).to(_stored_dtype(sgm, final=False))
    sweeps = _SWEEPS[_MODE_PATHS[sgm["sgbm_mode"]]]
    for i, (dxs, reverse) in enumerate(sweeps):
        total = s.to(torch.float32)
        for dx in dxs:
            total = total + _rows(cf, -1 if reverse else 1, dx, p1, p2)
        s = total.to(_stored_dtype(sgm, final=i == len(sweeps) - 1))
    return s


# ---------------------------------------------------------------- WTA

def _lr_invalid(d0, min_s, valid, max_diff, min_disp, num_disp):
    h, w = d0.shape
    dev = d0.device
    pad_r = num_disp + min_disp
    noclaim, none, low = 1 << 29, 1 << 30, 255
    key = torch.where(valid, min_s * 256 + d0, noclaim).to(torch.int32)
    key_pad = torch.cat([key, torch.full((h, pad_r), noclaim, dtype=torch.int32,
                                         device=dev)], 1)
    packed = torch.full((h, w), none, dtype=torch.int32, device=dev)
    for d in range(num_disp):
        cand = key_pad[:, d + min_disp:d + min_disp + w]
        packed = torch.minimum(packed, torch.where((cand & low) == d, cand, none))
    disp2 = torch.where(packed >= noclaim, _BIG_KEY, packed & low).to(torch.int32)
    d2_pad = torch.cat([torch.full((h, pad_r), -_BIG_KEY, dtype=torch.int32, device=dev),
                        disp2], 1)
    bad = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for d in range(num_disp):
        off = d + min_disp
        at = d2_pad[:, pad_r - off:pad_r - off + w]
        bad = bad | ((d0 == d) & (torch.abs(at - d) > max_diff))
    return bad


def wta(s, sgm, dt) -> torch.Tensor:
    """Winner-take-all on S (H, W, D) int16: disparity in dt on the 1/16
    grid, invalid = min_disp - 1."""
    num_d, dev = s.shape[-1], s.device
    min_disp = sgm["min_disp"]
    d_idx = torch.arange(num_d, dtype=torch.int32, device=dev)
    sent = torch.iinfo(torch.int16).max
    pmin = (s.to(torch.int32) * 256 + d_idx).amin(dim=-1)
    min_s, d0 = pmin >> 8, pmin & 255

    def at(dd):
        inside = (dd >= 0) & (dd < num_d)
        g = torch.gather(s, -1, dd.clamp(0, num_d - 1)[..., None].long())[..., 0]
        return torch.where(inside, g.to(torch.int32), sent)

    cm, cp = at(d0 - 1), at(d0 + 1)
    invalid = torch.zeros(d0.shape, dtype=torch.bool, device=dev)
    ur = sgm["uniqueness_ratio"]
    if ur > 0:
        near = torch.abs(d_idx - d0[..., None]) <= 1
        comp = torch.where(near, torch.full((), sent, dtype=s.dtype, device=dev), s)
        invalid = comp.amin(dim=-1).to(torch.int32) * (100 - ur) < min_s * 100
    if sgm["disp12_max_diff"] >= 0:
        invalid = invalid | _lr_invalid(d0, min_s, ~invalid, sgm["disp12_max_diff"],
                                        min_disp, num_d)
    denom = torch.clamp(cm + cp - 2 * min_s, min=1)
    delta16 = torch.div((cm - cp) * 16 + denom, 2 * denom, rounding_mode="trunc")
    delta16 = torch.where((d0 > 0) & (d0 < num_d - 1), delta16, 0)
    disp = ((min_disp + d0) * 16 + delta16).to(dt) / torch.full((), 16.0, dtype=dt,
                                                                 device=dev)
    return torch.where(invalid, torch.full((), float(min_disp - 1), dtype=dt, device=dev),
                       disp)


# ---------------------------------------------------------------- filters

def _planes3x3(x):
    p = _pad(x, 1, "replicate")
    h, w = x.shape
    return [p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def median3x3(x):
    v = _planes3x3(x)
    for i, j in [(1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
                 (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
                 (4, 2)]:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def box_mean(x, k):
    r = k // 2
    p = _pad(x, r, "reflect")
    h, w = p.shape[0] - 2 * r, p.shape[1] - 2 * r
    s = p[0:h]
    for i in range(1, k):
        s = s + p[i:i + h]
    t = s[:, 0:w]
    for i in range(1, k):
        t = t + s[:, i:i + w]
    return t / _const(float(k * k), t)


def _nb(arr, dy, dx, fill):
    h, w = arr.shape
    out = torch.full_like(arr, fill)
    out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = (
        arr[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)])
    return out


def filter_speckles(d, new_val, max_size, max_diff):
    """cv2.filterSpeckles: 4-connected components of neighbours within
    max_diff; components of at most max_size pixels become new_val.
    Min-label flood fill, BFS distances from each root, parent pointers,
    a subtree count and the root's verdict spread back."""
    h, w = d.shape
    n = h * w
    big, inf = float(n), float(n + 8)
    valid = d != new_val
    dirs = ((-1, 0), (1, 0), (0, -1), (0, 1))
    same = []
    for dy, dx in dirs:
        nd = _nb(d, dy, dx, float("inf"))
        same.append(valid & _nb(valid, dy, dx, False) & (torch.abs(d - nd) <= max_diff))
    idx = torch.arange(n, dtype=torch.float32, device=d.device).reshape(h, w)
    labels = torch.where(valid, idx, big)
    steps = (int(max_size) // _SPECKLE_UNROLL + 2) * _SPECKLE_UNROLL
    for _ in range(steps):
        out = labels
        for (dy, dx), s in zip(dirs, same):
            out = torch.minimum(out, torch.where(s, _nb(labels, dy, dx, big), big))
        labels = out
    conn = []
    poison = torch.zeros((h, w), dtype=torch.bool, device=d.device)
    for (dy, dx), s in zip(dirs, same):
        agree = _nb(labels, dy, dx, big) == labels
        conn.append(s & agree)
        poison = poison | (s & ~agree)
    dist = torch.where(valid & (labels == idx), 0.0, inf)
    for _ in range(steps):
        best = torch.full_like(dist, inf)
        for k, (dy, dx) in enumerate(dirs):
            best = torch.minimum(best, torch.where(conn[k], _nb(dist, dy, dx, inf), inf))
        dist = torch.minimum(dist, best + 1.0)
    parent = torch.full((h, w), -1.0, dtype=torch.float32, device=d.device)
    for k in range(3, -1, -1):
        dy, dx = dirs[k]
        ok = conn[k] & (_nb(dist, dy, dx, inf) == dist - 1.0)
        parent = torch.where(ok, float(k), parent)
    opp = (1.0, 0.0, 3.0, 2.0)
    child = [conn[k] & (_nb(parent, dy, dx, -1.0) == opp[k])
             for k, (dy, dx) in enumerate(dirs)]
    seed = torch.where(poison, float(int(max_size) + 2), 1.0)
    count = seed
    for _ in range(steps):
        total = seed
        for k, (dy, dx) in enumerate(dirs):
            total = total + torch.where(child[k], _nb(count, dy, dx, 0.0), 0.0)
        count = total
    rem = (dist == 0.0) & (count <= int(max_size))
    for _ in range(steps):
        for k, (dy, dx) in enumerate(dirs):
            rem = rem | (conn[k] & _nb(rem, dy, dx, False))
    return torch.where(rem, _const(float(new_val), d), d)


def _detect_outliers(d, threshold, k):
    valid = d > 0
    mean, mean_sq = box_mean(d, k), box_mean(d * d, k)
    std = torch.sqrt(torch.clamp(mean_sq - mean * mean, min=0.0))
    return (torch.abs(d - mean) > threshold * std) & valid


def _push_pull(x, hole):
    v = torch.where(hole, _const(0.0, x), x)
    m = (~hole).to(x.dtype)

    def pool2(a):
        return a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]

    def down(v, m):
        h, w = v.shape
        if h % 2 or w % 2:
            v = F.pad(v, (0, w % 2, 0, h % 2))
            m = F.pad(m, (0, w % 2, 0, h % 2))
        vs, ms = pool2(v), pool2(m)
        return vs / torch.clamp(ms, min=1.0), torch.clamp(ms, max=1.0)

    pyramid = [(v, m)]
    while max(pyramid[-1][0].shape) > 1:
        pyramid.append(down(*pyramid[-1]))
    vc, _ = pyramid[-1]
    for v_l, m_l in reversed(pyramid[:-1]):
        h, w = v_l.shape
        up = vc.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
        vc = torch.where(m_l > 0, v_l, up)
    return torch.where(hole, vc, x)


def _fill_holes(d, iters=25):
    mask = d <= 0
    f = _push_pull(d, mask)
    for _ in range(max(iters // 5, 1) * 5):
        p = _pad(f, 1, "replicate")
        avg = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
        f = torch.where(mask, avg, f)
    return f


def postprocess(d, hole_filling, max_speckle):
    """Speckle filter (new value 0, max diff 1), outlier removal at 2.5
    sigma over 5x5, optional push-pull inpaint, 3x3 median."""
    r = filter_speckles(d, 0.0, max_speckle, 1.0)
    r = torch.where(_detect_outliers(r, 2.5, 5), _const(0.0, r), r)
    if hole_filling:
        r = _fill_holes(r)
    return median3x3(r)


def wls(p, i, radius, eps):
    """Confidence-weighted guided filter of p steered by i."""
    k = 2 * radius + 1
    w = (p > 0.0).to(p.dtype)
    mean_i = box_mean(i, k)
    var_i = torch.clamp(box_mean(i * i, k) - mean_i * mean_i, min=0.0)
    wsum = torch.clamp(box_mean(w, k), min=1e-4)
    mean_p = box_mean(w * p, k) / wsum
    mean_ip = box_mean(w * i * p, k) / wsum
    mean_i_w = box_mean(w * i, k) / wsum
    a = (mean_ip - mean_i_w * mean_p) / (var_i + eps)
    b = mean_p - a * mean_i_w
    return box_mean(a, k) * i + box_mean(b, k)


def to_depth(disp, sgm):
    """Z = f * B / (d + doffs) where d + doffs > min_disp, else +inf."""
    adjusted = disp + sgm["doffs"]
    valid = adjusted > float(sgm["min_disp"])
    fb = _const(sgm["focal_length"] * sgm["baseline"], disp)
    z = torch.where(valid, fb / torch.where(valid, adjusted, _const(1.0, disp)),
                    _const(float("inf"), disp))
    if sgm.get("max_depth") is not None:
        z = torch.clamp(z, max=sgm["max_depth"])
    return z


# ---------------------------------------------------------------- pipeline

def stereo_depth(left_rgb, right_rgb, sgm: dict, fast_mode: bool, dt=torch.float32):
    """(disparity, depth) of a uint8 RGB pair, both (H, W - num_disp),
    in dt. Follows the pipeline's stage order: matcher, in-matcher
    speckle filter, crop, median (fast mode) or full postprocess, WLS,
    depth."""
    check_supported(sgm)
    left, right = gray(left_rgb), gray(right_rgb)
    d = wta(aggregate(cost_volume(left, right, sgm), sgm), sgm, dt)
    if sgm["speckle_window_size"] > 0:
        d = filter_speckles(d, float(sgm["min_disp"] - 1), sgm["speckle_window_size"],
                            float(sgm["speckle_range"]))
    d = d[:, sgm["num_disp"]:]
    d = median3x3(d) if fast_mode else postprocess(d, sgm["hole_filling"], 100)
    if sgm["wls_filter"]:
        d = wls(d, left[:, sgm["num_disp"]:].to(dt), sgm["wls_radius"], sgm["wls_eps"])
    return d, to_depth(d, sgm)
