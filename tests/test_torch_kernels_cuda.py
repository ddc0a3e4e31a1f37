"""The CUDA kernels (matcher and remap) against their plain PyTorch
versions on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports nothing of JAX; on a machine with a
card and no JAX, run it without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from depthestimation_torch import SGMConfig, StereoDepthEstimator
from depthestimation_torch.ops import cuda_sgm, filters, remap

pytestmark = pytest.mark.cuda

# (h, w, config): several D per lane (1, 2, 4, 8), min_disp, a partial
# last K1 tile, block sizes 1 to 17 and every int16/int32 storage
# combination. K1 edge geometry: a block covers 32 - 2r rows (28 at block
# size 5, 32 at 1), 64 columns and 64 disparities, so the cases below also
# take H under one strip and one row past it, W under one tile, and D of
# 16 (one d-block, 2 of its 8 warps busy) and 256 (four d-blocks).
CASES = [
    (24, 100, dict(num_disp=16)),
    (37, 150, dict(num_disp=48, min_disp=3)),
    (40, 200, dict(num_disp=32, block_size=3)),
    (64, 300, dict(num_disp=128)),
    (33, 330, dict(num_disp=256, block_size=3)),
    (30, 190, dict(num_disp=64, block_size=11)),
    (30, 190, dict(num_disp=64, block_size=7, prefilter_cap=100)),
    (30, 190, dict(num_disp=64, block_size=13, prefilter_cap=1)),
    (5, 90, dict(num_disp=16)),
    (29, 140, dict(num_disp=32, min_disp=5)),
    (33, 90, dict(num_disp=16, block_size=1)),
    (12, 50, dict(num_disp=16, block_size=3)),
    (9, 300, dict(num_disp=256, block_size=1, min_disp=2)),
    (20, 130, dict(num_disp=80, block_size=15, prefilter_cap=1)),
    (17, 70, dict(num_disp=16, block_size=17, prefilter_cap=1)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# The K3 passes of the four modes, as (dxs, reverse).
SWEEPS = [((0,), False), ((0,), True), ((0, 1, -1), False), ((0, -1, 1), True)]


def pair(h, w, shift, seed, device, fractional=False):
    """Integer-valued pair, or with fractional=True a smoothed float one
    (like a rectified image), where float32 sums round."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    if fractional:
        base = (base + np.roll(base, 1, 0) * 0.7 + np.roll(base, 1, 1) * 0.3) / 2.1
    left = torch.tensor(base[:, :w], device=device)
    right = torch.tensor(base[:, shift:], device=device)
    return left, right


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.to(torch.int64) - want.to(torch.int64)).abs().max()


@pytest.mark.parametrize("h,w,kw", CASES)
def test_kernels_match_plain(card, h, w, kw):
    cfg = SGMConfig(**kw)
    left, right = pair(h, w, 7, seed=h + w, device=card)
    final = cuda_sgm._final_dtype(cfg)
    cuda_sgm.reset_launches()
    c = cuda_sgm.cost_volume(left, right, cfg)
    swe = cuda_sgm.hscan(c, cfg)
    s = cuda_sgm.rowsweep(c, swe, cfg, (0,), False, final)
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda_sgm.LAUNCHES.items() if v}
    assert counts == {"cost_volume": 1, "hscan": 2, "rowsweep": 1}
    calls = {k: v for k, v in cuda_sgm.CALLS.items() if v}
    assert calls == {"cost_volume": 1, "hscan": 1, "rowsweep": 1}
    assert swe.dtype == cuda_sgm._acc_dtype(cfg)
    assert s.dtype == final
    assert_same(c, cuda_sgm.cost_volume_plain(left, right, cfg))
    assert_same(swe, cuda_sgm.hscan_plain(c, cfg))
    assert_same(s, cuda_sgm.rowsweep_plain(c, swe, cfg, (0,), False, final))
    # The plain versions on the card agree with the CPU.
    assert_same(c.cpu(), cuda_sgm.cost_volume(left.cpu(), right.cpu(), cfg))


@pytest.mark.parametrize("h,w,kw", CASES)
def test_cost_volume_fractional_and_census(card, h, w, kw):
    """K1's window sum runs in the plain version's order, so BT is exact
    on fractional input too; census is exact on integer words."""
    cfg = SGMConfig(**kw)
    left, right = pair(h, w, 7, seed=h * w, device=card, fractional=True)
    got = cuda_sgm.cost_volume(left, right, cfg)
    assert_same(got, cuda_sgm.cost_volume_plain(left, right, cfg))
    assert_same(got.cpu(), cuda_sgm.cost_volume(left.cpu(), right.cpu(), cfg))
    census = SGMConfig(cost="census", **kw)
    left, right = pair(h, w, 7, seed=h + w, device=card)
    cuda_sgm.reset_launches()
    got = cuda_sgm.cost_volume(left, right, census)
    assert cuda_sgm.LAUNCHES["cost_volume_census"] == 1
    assert cuda_sgm.CALLS["cost_volume_census"] == 1
    assert_same(got, cuda_sgm.cost_volume_plain(left, right, census))


@pytest.mark.parametrize("dxs,reverse", SWEEPS)
@pytest.mark.parametrize("h,w,kw", CASES)
def test_rowsweep_variants_match_plain(card, h, w, kw, dxs, reverse):
    cfg = SGMConfig(**kw)
    left, right = pair(h, w, 7, seed=h + w, device=card)
    c = cuda_sgm.cost_volume(left, right, cfg)
    acc = cuda_sgm.hscan(c, cfg)
    for out_dtype in (cuda_sgm._acc_dtype(cfg), cuda_sgm._final_dtype(cfg)):
        cuda_sgm.reset_launches()
        got = cuda_sgm.rowsweep(c, acc, cfg, dxs, reverse, out_dtype)
        torch.cuda.synchronize()
        name = cuda_sgm._rowsweep_name(dxs, reverse)
        assert cuda_sgm.LAUNCHES[name] == len(dxs)
        assert cuda_sgm.CALLS[name] == 1
        assert_same(got, cuda_sgm.rowsweep_plain(c, acc, cfg, dxs, reverse,
                                                 out_dtype))


# K2/K3 geometry on random costs (the scans take any (H, W) volume). A ring
# stage is 32/K columns for K2 and 16/K pixels for K3 (K = D/32 rounded up
# to 1, 2, 4, 8): W under one K2 stage (5 at D=16, 7 at D=128) and not a
# multiple of it (45, 13, 70); H much larger than W and W much larger than
# H for the diagonals; D 16 and 256; int32 acc and out at block sizes 11
# and 13.
SCAN_CASES = [
    (1, 5, dict(num_disp=16)),
    (3, 45, dict(num_disp=16, block_size=3)),
    (2, 13, dict(num_disp=128)),
    (5, 7, dict(num_disp=128)),
    (60, 4, dict(num_disp=48, block_size=3)),
    (4, 70, dict(num_disp=256, block_size=3)),
    (9, 33, dict(num_disp=256, block_size=1)),
    (20, 30, dict(num_disp=64, block_size=11)),
    (17, 21, dict(num_disp=32, block_size=13, prefilter_cap=15)),
]


@pytest.mark.parametrize("h,w,kw", SCAN_CASES)
def test_scans_geometry_match_plain(card, h, w, kw):
    cfg = SGMConfig(sgbm_mode="hh", **kw)
    rng = np.random.default_rng(h * w + cfg.num_disp)
    c = torch.tensor(rng.integers(0, cuda_sgm._cmax(cfg) + 1, (h, w, cfg.num_disp))
                     .astype(np.int16), device=card)
    swe = cuda_sgm.hscan(c, cfg)
    assert_same(swe, cuda_sgm.hscan_plain(c, cfg))
    acc_dt, final_dt = cuda_sgm._acc_dtype(cfg), cuda_sgm._final_dtype(cfg)
    for dxs, reverse in SWEEPS:
        for out_dtype in (acc_dt, final_dt):
            got = cuda_sgm.rowsweep(c, swe, cfg, dxs, reverse, out_dtype)
            assert_same(got, cuda_sgm.rowsweep_plain(c, swe, cfg, dxs, reverse,
                                                     out_dtype))
    # hh's upward pass on the output of its downward pass.
    s5 = cuda_sgm.rowsweep(c, swe, cfg, (0, 1, -1), False, acc_dt)
    got = cuda_sgm.rowsweep(c, s5, cfg, (0, -1, 1), True, final_dt)
    assert_same(got, cuda_sgm.rowsweep_plain(c, s5, cfg, (0, -1, 1), True, final_dt))


# w % 4 != 0 (13x103, 7x129, 9x6) takes the kernel's scalar form.
@pytest.mark.parametrize("h,w", [(24, 100), (37, 150), (64, 300), (5, 700),
                                 (13, 103), (7, 129), (9, 6)])
def test_remap_matches_plain(card, h, w):
    rng = np.random.default_rng(h + w)
    img = torch.tensor(rng.uniform(0, 255, (2, h, w)).astype(np.float32), device=card)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # Warps that leave the image on every side, and one far outside.
    mx = np.stack([xx * 1.03 - 2.2 + 2.5 * np.sin(yy / 5), xx + 0.37])
    my = np.stack([yy * 1.05 - 1.4 + 1.5 * np.cos(xx / 11), yy - 1e6])
    mx, my = (torch.tensor(m.astype(np.float32), device=card) for m in (mx, my))
    cuda_sgm.reset_launches()
    got = remap.remap_bilinear(img, mx, my)
    torch.cuda.synchronize()
    assert cuda_sgm.LAUNCHES["remap"] == 1
    assert cuda_sgm.CALLS["remap"] == 1
    want = remap.remap_bilinear_plain(img, mx, my)
    assert torch.equal(got, want), (got - want).abs().max()
    assert torch.equal(got.cpu(), remap.remap_bilinear(img.cpu(), mx.cpu(), my.cpu()))
    assert (got[1] == 0).all()
    # N = 1, as (H, W) and as (1, H, W).
    for one in (img[0], img[:1]):
        got = remap.remap_bilinear(one, mx[0].reshape(one.shape), my[0].reshape(one.shape))
        assert torch.equal(got.reshape(h, w), want[0])
    # A map 4 bytes past a 16-byte boundary takes the scalar form.
    buf = torch.zeros(h * w + 1, device=card)
    buf[1:] = mx[0].flatten()
    got = remap.remap_bilinear(img[0], buf[1:].view(h, w), my[0])
    assert torch.equal(got, want[0])


@pytest.mark.parametrize("kw", [dict(), dict(sgbm_mode="hh4"),
                                dict(sgbm_mode="sgbm"), dict(sgbm_mode="hh"),
                                dict(cost="census")])
def test_matcher_and_estimator_match_cpu(card, kw):
    left, right = pair(48, 256, 9, seed=3, device=card)
    cfg = SGMConfig(num_disp=64, **kw)
    got = cuda_sgm.sgm_disparity(left, right, cfg)
    assert torch.equal(got, cuda_sgm.sgm_disparity_plain(left, right, cfg))
    assert torch.equal(got.cpu(), cuda_sgm.sgm_disparity(left.cpu(), right.cpu(), cfg))
    if kw:
        return

    rgb = [np.repeat(t.cpu().numpy().astype(np.uint8)[..., None], 3, -1)
           for t in (left, right)]
    outs = []
    for device in ("cuda", "cpu"):
        est = StereoDepthEstimator(device=device)
        est.left_source, est.right_source = rgb
        est.configure_sgbm(num_disp=64, focal_length=500.0, baseline=0.1)
        outs.append(est.estimate_depth())
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5)


def test_box_mean_matches_cpu(card):
    """The WLS box means divide alike on both devices (CUDA would multiply
    by the reciprocal of a host scalar divisor)."""
    x = torch.tensor(np.random.default_rng(5).uniform(0, 255, (40, 90)).astype(np.float32))
    assert torch.equal(filters.box_mean(x.to(card), 17).cpu(), filters.box_mean(x, 17))


def test_wrapper_checks(card):
    cfg = SGMConfig(num_disp=16)
    c = torch.zeros((8, 64, 16), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        cuda_sgm.hscan(c, cfg)
    c = torch.zeros((8, 16, 64), dtype=torch.int16, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sgm.hscan(c, cfg)
    c = torch.zeros((8, 64, 16), dtype=torch.int16, device=card)
    with pytest.raises(ValueError, match="shape"):
        cuda_sgm.rowsweep(c, torch.zeros((8, 64, 32), dtype=torch.int16, device=card),
                          cfg, (0,), False, torch.int16)
    with pytest.raises(ValueError, match="dxs"):
        cuda_sgm.rowsweep(c, c, cfg, (0, 2), False, torch.int16)
    img = torch.zeros((8, 64), device=card)
    with pytest.raises(ValueError, match="shape"):
        remap.remap_bilinear(img, img, torch.zeros((8, 63), device=card))
    # Shapes K1 does not take are refused by the kernel, not computed.
    for kw in (dict(num_disp=272), dict(block_size=19, prefilter_cap=1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            cuda_sgm.cost_volume(img, img, SGMConfig(**kw))
