"""The monocular path on the card: the tiny net and the full-width `small`
preset against the CPU, the card's preprocessing equal to the CPU's bit
for bit, and a steady predict() that never waits for the card before its
read-back.

Tolerances (max abs diff over the max abs value of the CPU output):
- 1e-4 with TF32 off: float32 on both sides, sums in other orders;
- 2e-2 with TF32 on (PyTorch's default for cuDNN convolutions): TF32
  keeps 10 mantissa bits, a relative 2^-11 per rounded operand, on every
  convolution of the path (the patch embedding, whose error the blocks
  carry, and about twenty in the head).

Every test here needs an NVIDIA GPU and skips without one. This file
imports nothing of JAX; on a machine with a card and no JAX, run it
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_mono_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from depthestimation_torch.models.dpt import DPTConfig
from depthestimation_torch.models.mono import MonoDepthModel, preprocess_image
from depthestimation_torch.models.vit import ViTConfig

pytestmark = pytest.mark.cuda

TOL = {False: 1e-4, True: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def tf32(request):
    """Set cuDNN's TF32 flag for one test and restore it after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = request.param
    yield request.param
    torch.backends.cudnn.allow_tf32 = before


def card_against_cpu(model, hw, card):
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = model.net(x)
        on_card = MonoDepthModel(net=copy.deepcopy(model.net)).to_device(card)
        got = on_card.net(x.to(card)).cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("tf32", [False, True], indirect=True)
@pytest.mark.parametrize("hw", [(56, 56), (84, 112), (28, 42)])
def test_tiny_net_card_against_cpu(card, tf32, hw):
    model = MonoDepthModel.from_configs(
        ViTConfig(image_size=56, patch_size=14, hidden_size=64, num_layers=2,
                  num_heads=2, out_layers=(0, 0, 1, 1)),
        DPTConfig(features=32, reassemble_channels=(16, 16, 32, 32), head_features=16),
        device="cpu")
    assert card_against_cpu(model, hw, card) <= TOL[tf32]


@pytest.mark.parametrize("tf32", [False, True], indirect=True)
def test_small_518_card_against_cpu(card, tf32):
    model = MonoDepthModel.create("small", seed=0, image_size=518, device="cpu")
    assert card_against_cpu(model, (518, 518), card) <= TOL[tf32]


@pytest.mark.parametrize("shape", [(1080, 1920), (60, 80), (40, 60)])
def test_preprocess_on_card_equals_cpu(card, shape):
    img = np.random.default_rng(1).integers(0, 256, (*shape, 3), dtype=np.uint8)
    got = preprocess_image(img, device=card)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), preprocess_image(img))


def test_steady_predict_never_waits(card):
    """Upload, preprocessing and forward of a steady predict make no call
    that waits for the card; only the read-back does."""
    model = MonoDepthModel.create("small", seed=0, device=card)
    img = np.random.default_rng(2).integers(0, 256, (270, 480, 3), dtype=np.uint8)
    want = model.predict(img)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = model.predict_async(img)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = pending.cpu().numpy()
    assert got.shape == (518, 924)
    # The same kernels on the same inputs; cuDNN's transposed convolution
    # may sum with atomics, so not asserted bit for bit.
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
