"""The WTA stage's CUDA kernel (csrc/wta_kernels.cu) against
wta_disparity_plain, bit for bit, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports nothing of JAX; on a machine with a
card and no JAX, run it without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_wta_cuda.py
"""

import numpy as np
import pytest
import torch

from depthestimation_torch import SGMConfig, pipeline
from depthestimation_torch.io.synthetic import synthesize_stereo_pair
from depthestimation_torch.ops import cuda_build, cuda_sgm, wta

pytestmark = pytest.mark.cuda

# A block selects one row, 32 pixels a warp, 128 a sweep of its four warps.
SWEEP = 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def bits(t):
    """A float32 tensor's bit patterns."""
    return t.contiguous().view(torch.int32)


def selected(s, *args):
    """wta_disparity on the card, checked to make one call of one launch,
    returned on the CPU."""
    cuda_build.reset_launches()
    got = wta.wta_disparity(s, *args)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["wta"] == 1 and cuda_build.CALLS["wta"] == 1
    assert got.dtype == torch.float32 and got.shape == s.shape[:2]
    return got.cpu()


def volume(h, w, d, dtype, seed):
    """Random costs with structure: each row's true disparity (below a
    third of the width) wins by far on 70 % of its pixels (so that the LR check keeps them), planted ties
    of two minima, and the rest random; int32 volumes also hold costs above
    the 2^20 sentinel and, on a few pixels, any 32-bit value."""
    rng = np.random.default_rng(seed)
    s = rng.integers(100, 400, (h, w, d)).astype(np.int64)
    true = rng.integers(0, max(1, min(d, w // 3)), h)
    for y in range(h):
        keep = rng.random(w) < 0.7
        s[y, keep, true[y]] = 20
        tie = rng.random(w) < 0.1
        s[y, tie, (true[y] + 5) % d] = 20
    if dtype == torch.int32:
        s *= 9000
        wild = rng.random((h, w)) < 0.02
        s[wild] = rng.integers(-2**31, 2**31, (int(wild.sum()), d))
    return torch.tensor(s).to(dtype)


def lr_rule(s, min_disp, uniqueness_ratio, max_diff):
    """The kernel's answer where the plain version cannot run the LR check
    (min_disp < 0 makes its shift loops slice from the end): the plain
    selection without the check, then OpenCV's rule on the survivors. Each
    claims right pixel xr = x - d0 - min_disp inside the row with its
    (cost, d0); a survivor fails where xr is outside the row, nobody
    claimed it, or the winner's d0 differs by more than max_diff. For
    non-negative costs below the int16 sentinel only."""
    base = wta.wta_disparity_plain(s, min_disp, uniqueness_ratio, -1).numpy()
    v = s.numpy().astype(np.int64)
    d0, min_s = v.argmin(-1), v.min(-1)
    valid = base != min_disp - 1
    out = base.copy()
    h, w = d0.shape
    for y in range(h):
        claim = {}
        for x in range(w):
            xr = x - d0[y, x] - min_disp
            if valid[y, x] and 0 <= xr < w:
                claim[xr] = min(claim.get(xr, (min_s[y, x], d0[y, x])), (min_s[y, x], d0[y, x]))
        for x in range(w):
            xr = x - d0[y, x] - min_disp
            if valid[y, x] and (xr not in claim or abs(claim[xr][1] - d0[y, x]) > max_diff):
                out[y, x] = min_disp - 1
    return torch.tensor(out)


@pytest.mark.parametrize("d", [16, 64, 128, 256, 288])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_kernel_matches_plain(card, dtype, d):
    """Random volumes at widths below and above a block's sweep, every
    combination of min_disp -5, 0 and 3, uniqueness ratio 0 and 10 and
    disp12_max_diff -1, 0 and 1: equal to wta_disparity_plain bit for bit
    (with min_disp -5 and the LR check on, to lr_rule); the LR check keeps
    some pixels and invalidates others."""
    for h, w, seed in ((3, SWEEP - 9, d), (4, 3 * SWEEP + 17, d + 1)):
        s = volume(h, w, d, dtype, seed)
        s_card = s.to(card)
        for min_disp in (-5, 0, 3):
            for ratio in (0, 10):
                for max_diff in (-1, 0, 1):
                    args = (min_disp, ratio, max_diff)
                    got = selected(s_card, *args)
                    if min_disp < 0 and max_diff >= 0:
                        want = lr_rule(s, *args) if dtype == torch.int16 else None
                    else:
                        want = wta.wta_disparity_plain(s, *args)
                    if want is not None:
                        assert torch.equal(bits(got), bits(want)), (h, w, args)
                    if max_diff >= 0 and min_disp >= 0:
                        valid = got != min_disp - 1
                        assert valid.float().mean() > 0.3 and not valid.all()


def edge_volumes():
    """name -> (volume on the CPU, (min_disp, uniqueness ratio, max diff))."""
    rng = np.random.default_rng(5)
    sentinel = np.full((3, 200, 64), 32767, np.int16)
    sentinel[:, ::7, 10] = 32766
    near = rng.integers(32700, 32768, (5, 90, 128)).astype(np.int16)
    cases = {
        "ties_int16": (torch.full((4, 150, 128), 77, dtype=torch.int16), (0, 10, 1)),
        "ties_int32": (torch.full((2, 40, 288), 5, dtype=torch.int32), (2, 10, 0)),
        "ties_no_uniqueness": (torch.full((2, 140, 64), 9, dtype=torch.int16), (0, 0, 1)),
        "int16_sentinel": (torch.tensor(sentinel), (0, 10, 1)),
        "near_sentinel": (torch.tensor(near), (1, 15, 1)),
        "one_pixel": (volume(1, 1, 128, torch.int16, 6), (0, 10, 1)),
        "width_31": (volume(2, 31, 64, torch.int16, 7), (0, 10, 1)),
        "width_129_odd_rows": (volume(7, SWEEP + 1, 128, torch.int32, 8), (1, 10, 1)),
        "odd_7x37": (volume(7, 37, 16, torch.int16, 9), (3, 10, 0)),
        "d_1": (volume(3, 50, 1, torch.int16, 10), (0, 10, 1)),
        "d_30_scalar_loads": (volume(3, 70, 30, torch.int16, 11), (0, 10, 1)),
        "d_30_int32": (volume(3, 70, 30, torch.int32, 18), (2, 10, 1)),
        "d_257": (volume(2, 300, 257, torch.int16, 12), (4, 10, 1)),
        "d_520": (volume(2, 600, 520, torch.int32, 13), (0, 10, 2)),
        # 6,000 columns of int64 claims: 60 KB of shared memory, above 48 KB.
        "wide_row_6000x288": (volume(2, 6000, 288, torch.int16, 14), (0, 10, 1)),
        "large_max_diff": (volume(3, 200, 64, torch.int16, 15), (0, 10, 2**31 - 1)),
        "ratio_above_100": (volume(3, 200, 64, torch.int32, 16), (0, 150, 1)),
    }
    # Fractional float costs: the float32 route's volume, rounded to int32.
    cases["float32"] = (torch.tensor(rng.random((4, 160, 64)) * 400, dtype=torch.float32),
                        (0, 10, 1))
    return cases


def test_edge_volumes(card):
    """Ties, costs at the int16 sentinel, widths of 1, 31 and 129, odd
    shapes, D = 1, 30 (scalar loads, int16 and int32), 257 and 520 (int64
    claims), a row
    whose claims take more than 48 KB of shared memory, a max diff of
    2^31 - 1, a ratio above 100, a float volume, and a volume that starts
    2 bytes into its storage: each equal to wta_disparity_plain bit for
    bit."""
    for name, (s, args) in edge_volumes().items():
        got = selected(s.to(card), *args)
        assert torch.equal(bits(got), bits(wta.wta_disparity_plain(s, *args))), name
    base = volume(3, 50, 17, torch.int16, 17).flatten()
    s = base[1:1 + 3 * 50 * 16].view(3, 50, 16)
    s_card = base.to(card)[1:1 + 3 * 50 * 16].view(3, 50, 16)
    assert s_card.is_contiguous() and s_card.data_ptr() % 8 != 0
    got = selected(s_card, 0, 10, 1)
    assert torch.equal(bits(got), bits(wta.wta_disparity_plain(s, 0, 10, 1)))


def test_real_volumes(card):
    """The aggregated volume S of a seeded 1080x1920 scene at D = 128
    (sgbm_3way's int16 final sum) and of a 240x720 one at D = 288 (hh at
    block size 7: an int32 sum), and the float32 route's volume of a
    120x320 pair: the kernel equals the plain version on the card, and the
    route's answer on the card equals the CPU's."""
    for w, h, d, kw, dtype in ((1920, 1080, 128, {}, torch.int16),
                               (720, 240, 288, dict(sgbm_mode="hh", block_size=7),
                                torch.int32)):
        left, right, _ = synthesize_stereo_pair(w, h, d, seed=w)
        core = pipeline.StereoPipeline(device=card)
        core.configure(num_disp=d, **kw)
        cfg = core.cfg
        gl, gr = core.prepare_rectified(left, right)
        c = cuda_sgm.cost_volume(gl, gr, cfg)
        s = cuda_sgm.hscan(c, cfg)
        sweeps = cuda_sgm._SWEEPS[cfg.num_paths]
        for i, (dxs, rev) in enumerate(sweeps):
            dt = (cuda_sgm._final_dtype(cfg) if i == len(sweeps) - 1
                  else cuda_sgm._acc_dtype(cfg))
            s = cuda_sgm.rowsweep(c, s, cfg, dxs, rev, dt)
        del c
        assert s.shape == (h, w, d) and s.dtype == dtype
        args = (cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff)
        got = selected(s, *args)
        want = wta.wta_disparity_plain(s, *args).cpu()
        assert torch.equal(bits(got), bits(want)), (h, w, d, s.dtype)
        assert (got > 0).float().mean() > 0.5
        del s
        torch.cuda.empty_cache()
    left, right, _ = synthesize_stereo_pair(320, 120, 64, seed=4)
    cfg = SGMConfig(num_disp=64, block_size=15, speckle_window_size=0)
    core = pipeline.StereoPipeline(device=card)
    core.configure(num_disp=64, block_size=15, speckle_window_size=0)
    gl, gr = core.prepare_rectified(left, right)
    s = pipeline.compute_disparity_volume(gl, gr, cfg)
    args = (cfg.min_disp, cfg.uniqueness_ratio, cfg.disp12_max_diff)
    got = selected(s, *args)
    assert torch.equal(bits(got), bits(wta.wta_disparity_plain(s, *args).cpu()))
    cuda_build.reset_launches()
    routed = pipeline.float32_disparity(gl, gr, cfg)
    assert cuda_build.CALLS["float32_route"] == 1 and cuda_build.CALLS["wta"] == 1
    assert torch.equal(routed.cpu(), pipeline.float32_disparity(gl.cpu(), gr.cpu(), cfg))


def test_default_pipeline_graph_equals_cpu(card):
    """A StereoPipeline with every default: the first call captures, two
    replays each launch the WTA kernel once, and both equal the CPU
    pipeline's pair."""
    left, right, _ = synthesize_stereo_pair(320, 120, 64, seed=3)
    kw = dict(num_disp=64, focal_length=500.0, baseline=0.1)
    cpu = pipeline.StereoPipeline(device="cpu")
    cpu.configure(**kw)
    want_disp, want_depth = cpu.estimate_depth_async(left, right)
    core = pipeline.StereoPipeline(device=card)
    core.configure(**kw)
    core.estimate_depth_async(left, right)
    for replay in (1, 2):
        cuda_build.reset_launches()
        disp, depth = core.estimate_depth_async(left, right)
        torch.cuda.synchronize()
        assert cuda_build.CALLS["wta"] == 1 and cuda_build.LAUNCHES["wta"] == 1
        (entry,) = core._graph_cache.values()
        assert entry.replays == replay
        assert torch.equal(disp.cpu(), want_disp)
        np.testing.assert_allclose(depth.cpu().numpy(), want_depth.numpy(), rtol=1e-5)
