"""The user-facing surface on the card: the matcher kernels and the remap
at examples.stereo's Middlebury geometry (994x1482 without calibration,
1988x2964 with it, 144 disparities) against their plain versions, and
examples.stereo from PNG files on the card against the CPU.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_surface_cuda.py
"""

import numpy as np
import pytest
import torch

from depthestimation_torch import SGMConfig, parse_calib_file
from depthestimation_torch.calib import RectificationCache
from depthestimation_torch.examples import stereo
from depthestimation_torch.io.synthetic import calib_text, write_demo_assets
from depthestimation_torch.ops import cuda_sgm, remap

pytestmark = pytest.mark.cuda

# examples/example_stereo.py's rig; downscale 0.5 gives D = 144.
MIDDLEBURY = dict(focal_px=3997.684, baseline_mm=193.001, doffs=131.111, width=2964,
                  height=1988, ndisp=280)
SHAPES = [(994, 1482), (1988, 2964)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.double() - want.double()).abs().max()


def pair(h, w, shift, seed, device, fractional):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
    if fractional:  # like a rectified image: float32 sums round
        base = (base + np.roll(base, 1, 0) * 0.7 + np.roll(base, 1, 1) * 0.3) / 2.1
    return (torch.tensor(base[:, :w], device=device),
            torch.tensor(base[:, shift:], device=device))


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("h,w", SHAPES)
def test_matcher_kernels_at_middlebury_geometry(card, h, w, fractional):
    cfg = SGMConfig(num_disp=144)
    left, right = pair(h, w, 61, seed=h, device=card, fractional=fractional)
    c = cuda_sgm.cost_volume(left, right, cfg)
    assert_same(c, cuda_sgm.cost_volume_plain(left, right, cfg))
    swe = cuda_sgm.hscan(c, cfg)
    assert_same(swe, cuda_sgm.hscan_plain(c, cfg))
    final = cuda_sgm._final_dtype(cfg)
    s = cuda_sgm.rowsweep(c, swe, cfg, (0,), False, final)
    assert_same(s, cuda_sgm.rowsweep_plain(c, swe, cfg, (0,), False, final))


@pytest.mark.parametrize("h,w", SHAPES)
def test_remap_at_middlebury_geometry(card, tmp_path, h, w):
    path = tmp_path / "calib.txt"
    path.write_text(calib_text(dict(MIDDLEBURY, width=w, height=h)))
    cfg = SGMConfig().updated(**parse_calib_file(str(path))["sgbm_kwargs"])
    mx, my = RectificationCache().device_maps(cfg.calib, cfg.baseline, 1.0, card)
    imgs = torch.rand(2, h, w, generator=torch.Generator().manual_seed(w)).to(card) * 255
    assert_same(remap.remap_bilinear(imgs, mx, my), remap.remap_bilinear_plain(imgs, mx, my))


@pytest.mark.parametrize("calibrated", [False, True])
def test_example_stereo_from_png_on_the_card(card, tmp_path, calibrated):
    """The demo pair (640x480) at 0.5, through the example on the card and
    on the CPU: the kernels' launches, and the card equal to the CPU."""
    paths = write_demo_assets(str(tmp_path / "assets"))
    args = [paths["left"], paths["right"], "--downscale", "0.5", "--no-viz"]
    if calibrated:
        args += ["--calib", paths["calib"]]
    cuda_sgm.reset_launches()
    got = stereo.run(args + ["--device", "cuda"])
    torch.cuda.synchronize()
    assert cuda_sgm.LAUNCHES["cost_volume"] == 1 and cuda_sgm.LAUNCHES["hscan"] == 2
    assert cuda_sgm.LAUNCHES["rowsweep"] == 1
    assert cuda_sgm.LAUNCHES["remap"] == int(calibrated)
    want = stereo.run(args + ["--device", "cpu"])
    assert np.array_equal(got.disparity_map, want.disparity_map)
    np.testing.assert_allclose(got.depth_map, want.depth_map, rtol=1e-5)


def test_dryrun_over_four_gpus(card):
    """entry.dryrun(4): one process per GPU over NCCL, mesh (1, 2, 2):
    row tiles, the disparity split, the train step with two 'model'
    ranks and predict_sharded within 1e-4 of the single forward."""
    from depthestimation_torch import entry

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four GPUs")
    assert entry.dryrun(4) is None
