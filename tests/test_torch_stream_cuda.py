"""The streaming path on the card: pairs staged by the input thread, a
steady-state frame that never waits for the card, and threaded input
equal to sequential input at 1080p.

Every test here needs an NVIDIA GPU and skips without one. This file
imports nothing of JAX; on a machine with a card and no JAX, run it
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_stream_cuda.py
"""

import numpy as np
import pytest
import torch

import depthestimation_torch as dt
from depthestimation_torch.io.threaded import PairStager, StereoInputPipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def texture_frames(n, h, w, shift, seed):
    """n RGB uint8 pairs of a smoothed random texture moved by `shift`
    pixels, brightness drifted by +i on frame i."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0
    left, right = [], []
    for i in range(n):
        img = np.clip(base + i, 0, 255).astype(np.uint8)
        left.append(np.repeat(img[:, :w, None], 3, -1))
        right.append(np.repeat(img[:, shift:, None], 3, -1))
    return left, right


def test_staged_pairs_on_card(card):
    left, right = texture_frames(5, 60, 100, 4, seed=0)
    pipe = StereoInputPipeline(left, right, device=card).start()
    try:
        got = [pair for pair in pipe]
    finally:
        pipe.stop()
    assert len(got) == 5
    for (gl, gr), fl, fr in zip(got, left, right):
        assert gl.device.type == "cuda" and gl.dtype == torch.uint8
        np.testing.assert_array_equal(gl.cpu().numpy(), fl)
        np.testing.assert_array_equal(gr.cpu().numpy(), fr)


@pytest.mark.parametrize("kw", [
    dict(speckle_window_size=0, wls_filter=True),   # stream A's flags
    dict(hole_filling=True, temporal_alpha=0.4),    # the live example's
])
def test_steady_frame_never_waits(card, kw):
    """A steady-state frame (stage, compute, float16 cast, read-back
    copies) makes no call that waits for the card."""
    left, right = texture_frames(3, 120, 400, 6, seed=1)
    vid = dt.StereoDepthEstimatorVideo(device=card, fast_mode="wls_filter" in kw)
    vid.configure_sgbm(num_disp=64, focal_length=500.0, baseline=0.1, **kw)
    stager = PairStager(card)

    def frame(i):
        l, r = stager.adopt(*stager.stage((left[i], right[i])))
        disp, depth = vid.core.estimate_depth_async(l, r)
        return vid._readback(disp, depth.to(torch.float16))

    frame(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = frame(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out[2].synchronize()
    assert out[1].dtype == torch.float16 and out[1].shape == (120, 400 - 64)
    assert out[0].is_pinned() and out[1].is_pinned()


def test_threaded_equals_sequential_1080p(card):
    left, right = texture_frames(10, 1080, 1920, 20, seed=2)
    outs = []
    for threaded in (True, False):
        vid = dt.StereoDepthEstimatorVideo(
            left, right, device=card, fast_mode=True, use_threading=threaded,
            target_fps=0, drop_frames=False)
        vid.configure_sgbm(num_disp=128, sgbm_mode="hh4", speckle_window_size=0,
                           wls_filter=True, focal_length=1000.0, baseline=0.12)
        outs.append(list(vid.estimate_depth()))
        assert vid.metrics.frames == 10 and vid.metrics.frames_failed == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    hit = (np.abs(1000.0 * 0.12 / outs[0][5] - 20) <= 1).mean()
    assert hit > 0.95
