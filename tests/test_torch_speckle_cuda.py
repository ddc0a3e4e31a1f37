"""The speckle filter's CUDA kernel (csrc/speckle_kernels.cu) against
filter_speckles_plain, bit for bit, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports nothing of JAX; on a machine with a
card and no JAX, run it without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_speckle_cuda.py
"""

import numpy as np
import pytest
import torch

from depthestimation_torch import SGMConfig, pipeline
from depthestimation_torch.io.synthetic import synthesize_stereo_pair
from depthestimation_torch.ops import cuda_build, filters

pytestmark = pytest.mark.cuda

# The kernel labels 32x32 tiles, then joins them along their seams.
TILE = 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def random_field(h, w, seed, new_val, levels=12, step=1.0):
    """Quantised random disparities (levels values `step` apart), 25 % of
    the pixels invalid (new_val)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, levels, (h, w)).astype(np.float32) * np.float32(step)
    d[rng.random((h, w)) < 0.25] = new_val
    return d


def snakes(new_val, window):
    """Two 1-px-wide serpentines on an invalid background, across a
    vertical seam and the first across a horizontal one (at window 100):
    window + 1 pixels (kept) and window pixels (removed)."""
    d = np.full((60, 40), new_val, np.float32)
    for value, length, row in ((7.0, window + 1, 28), (11.0, window, 40)):
        path, x, y, dx = [], 1, row, 1
        while len(path) < length:
            path.append((y, x))
            if not 1 <= x + dx <= 38:  # turn: down two rows
                path.append((y + 1, x))
                y, dx = y + 2, -dx
            else:
                x += dx
        for y, x in path[:length]:
            d[y, x] = value
    return d


def exact_sizes(new_val, window):
    """Components of exactly window pixels (removed) and window + 1 (kept)
    on an invalid background: a row across vertical seams, a row across
    vertical seams that wraps across the horizontal one at window 100, and
    an L of a column across a horizontal seam and a row across a vertical
    one."""
    d = np.full((3 * TILE + 5, 3 * TILE + 7), new_val, np.float32)
    cols = d.shape[1]

    def strip(y, x, n, value):  # n pixels, wrapping into the next row at x
        while n > 0:
            run = min(n, cols - x)
            d[y, x:x + run] = value
            n, y = n - run, y + 1

    strip(1, 0, window, 3.0)
    strip(TILE - 1, TILE - 9, window + 1, 5.0)
    n_col = window // 2
    top = 2 * TILE - n_col // 2
    d[top:top + n_col, TILE - 1] = 9.0
    d[top + n_col - 1, TILE:TILE + window - n_col] = 9.0
    return d


def whole_map(h, w):
    """One component covering the map: a sawtooth on the 1/16 grid from
    1/16 to 1, so that every pair of neighbours differs by at most 15/16."""
    y, x = np.mgrid[0:h, 0:w]
    return ((x + 2 * y) % 16 + 1).astype(np.float32) / 16.0


def nonfinite(h, w, seed, new_val):
    """A random field with NaN, +inf and -inf pixels (none joined to any
    neighbour) and a run of +inf."""
    d = random_field(h, w, seed, new_val, levels=4, step=0.5)
    rng = np.random.default_rng(seed + 1)
    for value in (np.nan, np.inf, -np.inf):
        d[rng.random((h, w)) < 0.05] = value
    d[5, 5:9] = np.inf
    return d


# name: (new_val, window) -> map
MAPS = {
    "random_7x19": lambda v, s: random_field(7, 19, 1, v),
    "random_33x65": lambda v, s: random_field(33, 65, 2, v),
    "random_100x250": lambda v, s: random_field(100, 250, 3, v),
    "random_fine_97x161": lambda v, s: random_field(97, 161, 4, v, levels=40, step=0.0625),
    "snakes": snakes,
    "exact_sizes": exact_sizes,
    "whole_map_70x90": lambda v, s: whole_map(70, 90),
    "whole_map_7x7": lambda v, s: whole_map(7, 7),  # 49 pixels: removed
    "nonfinite_40x77": lambda v, s: nonfinite(40, 77, 5, v),
}


def bits(t):
    """A float32 tensor's bit patterns, so that NaN compares equal."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("window", [50, 100])
@pytest.mark.parametrize("new_val", [-1.0, 0.0])
@pytest.mark.parametrize("name", list(MAPS))
def test_kernel_matches_plain(card, name, new_val, window):
    """Every map of MAPS, both new_val and both windows: the kernel equals
    filter_speckles_plain on the CPU bit for bit, in one call of four
    launches."""
    d = torch.tensor(MAPS[name](new_val, window))
    cuda_build.reset_launches()
    got = filters.filter_speckles(d.to(card), new_val, window, 1.0)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["speckle"] == 4 and cuda_build.CALLS["speckle"] == 1
    want = filters.filter_speckles_plain(d, new_val, window, 1.0)
    assert got.dtype == torch.float32 and got.shape == d.shape
    assert torch.equal(bits(got.cpu()), bits(want))
    removed = (want == new_val) & (d != new_val)
    if name == "exact_sizes":
        assert removed[1, 0] and not removed[TILE - 1, TILE - 9]
        assert removed[2 * TILE, TILE - 1]
    if name == "snakes":
        assert not removed[28, 1] and removed[40, 1]


def test_raw_disparity_1080p(card):
    """The matcher's raw disparity of a seeded 1080x1920 pair, speckle off,
    through both of the pipeline's calls: window 50 with new_val
    min_disp - 1 on the whole map, window 100 with 0 on the crop (a strided
    view). Equal to the plain version on the card, which equals the CPU's."""
    left, right, _ = synthesize_stereo_pair(1920, 1080, 128, seed=11)
    core = pipeline.StereoPipeline(device=card)
    core.configure(num_disp=128, speckle_window_size=0)
    gl, gr = core.prepare_rectified(left, right)
    disp = pipeline.raw_disparity(gl, gr, core.cfg)
    cfg = SGMConfig()
    cuda_build.reset_launches()
    for x, new_val, window in ((disp, float(cfg.min_disp - 1), cfg.speckle_window_size),
                               (disp[:, 128:], 0.0, 100)):
        got = filters.filter_speckles(x, new_val, window, 1.0)
        want = filters.filter_speckles_plain(x, new_val, window, 1.0)
        assert torch.equal(got, want)
        assert (got != x).any()  # speckles were removed
    assert cuda_build.CALLS["speckle"] == 2 and cuda_build.LAUNCHES["speckle"] == 8


def test_default_pipeline_graph_equals_cpu(card):
    """A StereoPipeline with every default: the first call captures, two
    replays each call the kernel twice (the matcher's filter and the
    postprocess's), and both equal the CPU pipeline's pair."""
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
        assert cuda_build.CALLS["speckle"] == 2 and cuda_build.LAUNCHES["speckle"] == 8
        (entry,) = core._graph_cache.values()
        assert entry.replays == replay
        assert torch.equal(disp.cpu(), want_disp)
        np.testing.assert_allclose(depth.cpu().numpy(), want_depth.numpy(), rtol=1e-5)
