"""The CUDA matcher kernels against their plain PyTorch versions on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports nothing of JAX; on a machine with a
card and no JAX, run it without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from depthestimation_torch import SGMConfig, StereoDepthEstimator
from depthestimation_torch.ops import cuda_sgm

pytestmark = pytest.mark.cuda

# (h, w, config): several D per lane (1, 2, 4, 8), min_disp, a partial
# last K1 tile, block sizes 3 to 13 and every int16/int32 storage combination.
CASES = [
    (24, 100, dict(num_disp=16)),
    (37, 150, dict(num_disp=48, min_disp=3)),
    (40, 200, dict(num_disp=32, block_size=3)),
    (64, 300, dict(num_disp=128)),
    (33, 330, dict(num_disp=256, block_size=3)),
    (30, 190, dict(num_disp=64, block_size=11)),
    (30, 190, dict(num_disp=64, block_size=7, prefilter_cap=100)),
    (30, 190, dict(num_disp=64, block_size=13, prefilter_cap=1)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def pair(h, w, shift, seed, device):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
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
    cuda_sgm.reset_launches()
    c = cuda_sgm.cost_volume(left, right, cfg)
    swe = cuda_sgm.hscan(c, cfg)
    s = cuda_sgm.rowsweep(c, swe, cfg)
    torch.cuda.synchronize()
    assert cuda_sgm.LAUNCHES == {"cost_volume": 1, "hscan": 2, "rowsweep": 1}
    assert swe.dtype == cuda_sgm._acc_dtype(cfg)
    assert s.dtype == cuda_sgm._final_dtype(cfg)
    assert_same(c, cuda_sgm.cost_volume_plain(left, right, cfg))
    assert_same(swe, cuda_sgm.hscan_plain(c, cfg))
    assert_same(s, cuda_sgm.rowsweep_plain(c, swe, cfg))
    # The plain versions on the card agree with the CPU.
    assert_same(c.cpu(), cuda_sgm.cost_volume(left.cpu(), right.cpu(), cfg))


def test_matcher_and_estimator_match_cpu(card):
    left, right = pair(48, 256, 9, seed=3, device=card)
    cfg = SGMConfig(num_disp=64)
    got = cuda_sgm.sgm_disparity(left, right, cfg)
    assert torch.equal(got, cuda_sgm.sgm_disparity_plain(left, right, cfg))
    assert torch.equal(got.cpu(), cuda_sgm.sgm_disparity(left.cpu(), right.cpu(), cfg))

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
        cuda_sgm.rowsweep(c, torch.zeros((8, 64, 32), dtype=torch.int16, device=card), cfg)
