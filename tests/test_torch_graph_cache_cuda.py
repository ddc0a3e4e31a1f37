"""The CUDA graphs of the port's compiled-program caches on the card: every
replay equal to the eager functions bit for bit, results that survive the
next call, the temporal carry, the mono forward, launch counts that count
replays, and a capture that meets a host synchronisation raising.

Every test here needs an NVIDIA GPU and skips without one. This file
imports nothing of JAX; on a machine with a card and no JAX, run it
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_graph_cache_cuda.py
"""

import numpy as np
import pytest
import torch

import depthestimation_torch as dt
from depthestimation_torch import pipeline
from depthestimation_torch.graphs import CapturedCall
from depthestimation_torch.ops import cuda_build

pytestmark = pytest.mark.cuda

H, W, D = 64, 320, 64
BASE = dict(num_disp=D, focal_length=500.0, baseline=0.1)
# The mono net's graphed forward against its eager one, as a share of the
# output's max: the same kernels, so bit-equal is expected, but cuDNN's
# transposed convolution may sum with atomics (tests/test_torch_mono_cuda.py
# holds two eager predicts to the same bound).
MONO_TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rgb_frames(n, h=H, w=W, shift=9, seed=0):
    """n RGB uint8 pairs of a smoothed random texture moved by `shift`
    pixels, brightness drifted by +i on frame i."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0
    out = []
    for i in range(n):
        img = np.clip(base + i, 0, 255).astype(np.uint8)
        out.append(tuple(np.repeat(a[..., None], 3, -1).copy()
                         for a in (img[:, :w], img[:, shift:])))
    return out


def mild_rig(h, w):
    """The JAX bench's rectified rig scaled to (h, w): a 0.25 degree roll,
    light radial distortion."""
    fx = 1000.0 * w / 1920
    k = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    th = np.deg2rad(0.25)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    dist = np.array([-0.01, 0.002, 0.0, 0.0, 0.0])
    return dict(cam_matrix_L=k, cam_matrix_R=k, image_width=w, image_height=h,
                dist_coeff_L=dist, dist_coeff_R=dist, rotation=rot,
                focal_length=fx, baseline=0.12)


def eager(core, left, right, prev=None):
    """The eager pipeline on a raw pair: prepare_rectified, stereo_depth_fn."""
    gl, gr = core.prepare_rectified(left, right)
    return pipeline.stereo_depth_fn(gl, gr, core.cfg, core.downscale_factor,
                                    core.fast_mode, prev_disp=prev)


def assert_same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


CELLS = {
    "default": dict(BASE),
    "north_star": dict(BASE, speckle_window_size=0, wls_filter=True),
    "hh4": dict(BASE, sgbm_mode="hh4", speckle_window_size=0),
    "sgbm": dict(BASE, sgbm_mode="sgbm"),
    "hh": dict(BASE, sgbm_mode="hh", speckle_window_size=0, wls_filter=True),
    "census": dict(BASE, cost="census"),
    "rectified_hh4": dict(BASE, sgbm_mode="hh4", speckle_window_size=0, wls_filter=True,
                          **mild_rig(H, W)),
    "no_depth": dict(num_disp=D),
}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("cell", list(CELLS))
def test_replay_equals_eager(card, cell, fast):
    """estimate_depth_async captures on its first call and replays from
    the second, each result equal to the eager pipeline's bit for bit; the
    replay launches what the eager pair launches."""
    core = pipeline.StereoPipeline(fast_mode=fast, device=card)
    core.configure(**CELLS[cell])
    (l0, r0), (l1, r1) = rgb_frames(2, seed=1)
    first = core.estimate_depth_async(l0, r0)
    cuda_build.reset_launches()
    want = eager(core, l1, r1)
    torch.cuda.synchronize()
    eager_counts = cuda_build.counts()
    cuda_build.reset_launches()
    got = core.estimate_depth_async(l1, r1)
    torch.cuda.synchronize()
    assert cuda_build.counts() == eager_counts
    (entry,) = core._graph_cache.values()
    assert isinstance(entry, CapturedCall) and entry.replays == 1
    assert entry.pool_bytes > 0 and entry.capture_ms > 0
    assert_same(got, want)
    assert_same(first, eager(core, l0, r0))
    assert (got[1] is None) == (cell == "no_depth")


def test_compute_disparity_and_injected_matcher(card):
    """The matcher's entry ("matcher", cfg, shape) and the tail behind an
    injected matcher, both replayed and equal to the eager functions."""
    core = pipeline.StereoPipeline(device=card)
    core.configure(**BASE, wls_filter=True)
    pairs = [core.prepare_rectified(*p) for p in rgb_frames(3, seed=2)]
    for gl, gr in pairs:
        assert torch.equal(core.compute_disparity(gl, gr), pipeline.raw_disparity(gl, gr, core.cfg))
    core.compute_disparity = lambda l, r: pipeline.raw_disparity(l, r, core.cfg)
    for gl, gr in pairs:
        assert_same(core.process_pair_async(gl, gr),
                    pipeline.postprocess_and_depth(pipeline.raw_disparity(gl, gr, core.cfg),
                                                   core.cfg, guide=gl))
    assert sorted(k[0] for k in core._graph_cache) == ["matcher", "post"]
    assert all(e.replays == 2 for e in core._graph_cache.values())


def test_results_survive_the_next_call(card):
    """A returned tensor is a copy: frame 0's result is unchanged after
    frames 1 and 2 replay, on the plain and the rectified entries."""
    for kw in (BASE, dict(BASE, **mild_rig(H, W))):
        core = pipeline.StereoPipeline(device=card)
        core.configure(**kw)
        frames = rgb_frames(3, seed=3)
        outs = [core.estimate_depth_async(*f) for f in frames]
        for out, f in zip(outs, frames):
            assert_same(out, eager(core, *f))


@pytest.mark.parametrize("calibrated", [False, True])
def test_temporal_carry(card, calibrated):
    """Four frames with a reset_temporal() after the second: the first
    frame and the one after the reset take the entry without the carry,
    the others the temporal entry with the previous disparity copied into
    its static input; every frame equal to the eager chain."""
    core = pipeline.StereoPipeline(device=card)
    kw = dict(BASE, hole_filling=True, temporal_alpha=0.4)
    core.configure(**(dict(kw, **mild_rig(H, W)) if calibrated else kw))
    prev = None
    for i, f in enumerate(rgb_frames(5, seed=4)):
        if i == 2:
            core.reset_temporal()
            prev = None
        got = core.estimate_depth_async(*f)
        want = eager(core, *f, prev=prev)
        prev = want[0]
        assert_same(got, want)
    assert sorted(k[-1] for k in core._graph_cache) == [False, True]


def test_stream_frames_equal_eager(card):
    """StereoDepthEstimatorVideo with graphs: each yielded float16 depth
    map equal to the eager pipeline's, cast on the card; frames x the
    pair's launches."""
    frames = rgb_frames(5, seed=5)
    vid = dt.StereoDepthEstimatorVideo([f[0] for f in frames], [f[1] for f in frames],
                                       target_fps=0, fast_mode=True, depth_dtype="float16",
                                       device=card)
    vid.configure_sgbm(**BASE, sgbm_mode="hh4", speckle_window_size=0, wls_filter=True)
    cuda_build.reset_launches()
    got = list(vid.estimate_depth())
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["cost_volume"] == 5 and cuda_build.LAUNCHES["hscan"] == 10
    for g, f in zip(got, frames):
        want = eager(vid.core, *f)[1].half().cpu().numpy()
        assert np.array_equal(g.view(np.uint16), want.view(np.uint16))
    (stats,) = vid._stats_cache.values()
    assert isinstance(stats, CapturedCall) and stats.replays == 4


def test_mono_forward_replays(card):
    """MonoDepthModel.predict_async replays the net from its second call
    with a shape, within MONO_TOL of the eager forward (the same kernels,
    so bit-equal is expected); to_device clears the cache."""
    from depthestimation_torch.models.mono import MonoDepthModel, preprocess_image

    model = MonoDepthModel.create("small", seed=0, device=card)
    imgs = [np.random.default_rng(i).integers(0, 256, (518, 518, 3), dtype=np.uint8)
            for i in range(3)]
    outs = [model.predict_async(img) for img in imgs]
    (entry,) = model._graph_cache.values()
    assert isinstance(entry, CapturedCall) and entry.replays == 2
    with torch.inference_mode():
        for out, img in zip(outs, imgs):
            want = model.net(preprocess_image(img, device=card)[None])[0]
            err = float((out - want).abs().max() / want.abs().max())
            assert err <= MONO_TOL, err
    model.to_device(card)
    assert model._graph_cache == {}


def test_launch_counts_count_replays(card):
    """The first call counts the warm-up's launches (the capture's are
    taken back), every replay adds the pair's launches once."""
    core = pipeline.StereoPipeline(device=card)
    core.configure(**BASE, sgbm_mode="hh")
    (left, right), = rgb_frames(1, seed=6)
    gl, gr = core.prepare_rectified(left, right)
    cuda_build.reset_launches()
    core.process_pair_async(gl, gr)
    per_pair = cuda_build.counts()
    assert per_pair[0]["rowsweep_diag"] == 3 and per_pair[1]["rowsweep_diag"] == 1
    for n in (2, 3, 4):
        core.process_pair_async(gl, gr)
        assert cuda_build.counts() == tuple({k: n * v for k, v in c.items()} for c in per_pair)


def test_capture_runs_on_the_capturing_stream(card):
    """Inside a capture, cuda_build.stream() is the capturing stream, so
    the C entry points' launches land in the graph."""
    seen = []

    def fn(x):
        seen.append((torch.cuda.is_current_stream_capturing(), cuda_build.stream(),
                     torch.cuda.current_stream().cuda_stream))
        return x + 1

    call = CapturedCall(fn, "probe")
    x = torch.zeros(4, device=card)
    assert torch.equal(call(x), x + 1)
    assert torch.equal(call(x + 1), x + 2)
    (warm, _, _), (capturing, ours, torchs) = seen
    assert not warm and capturing and ours == torchs


def test_capture_with_a_host_sync_raises(card):
    """A callable that synchronises with the host cannot be captured: the
    call raises, nothing runs eagerly in its place, and the card and the
    caller's stream are as they were."""
    stream = torch.cuda.current_stream()

    def fn(x):
        return x * x.sum().item()

    call = CapturedCall(fn, "host sync")
    x = torch.arange(4.0, device=card)
    with pytest.raises(RuntimeError, match="capture of host sync as a CUDA graph failed"):
        call(x)
    assert call.graph is None
    assert torch.cuda.current_stream() == stream
    assert torch.equal((x + 1).cpu(), torch.arange(1.0, 5.0))
