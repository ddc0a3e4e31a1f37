"""The frozen reference equals the port's plain versions bit for bit, on
small seeded pairs (the test imports the port; the reference does not),
and its lower-precision control does not pass the check."""

import numpy as np
import pytest
import torch
from conftest import CELLS, STREAM, load, tiny

import depthestimation_torch as dt
from benchlib import scenes, spec

ref = spec.load_module("reference", "stereo")

SCENE = {"layout_seed": 3, "background": 0.06, "planes": [[0.3, 0.3, 0.5], [0.6, 0.25, 0.4], [0.9, 0.2, 0.3]],
         "channel_gain": [0.9, 0.85, 0.8], "noise": 1.5}


def _pairs(seed, n=2, h=40, w=112, d=32):
    return scenes.pair_pool(seed, n, h, w, d, SCENE, torch.device("cpu"))


def _sgm(config, d=32, **kw):
    sgm = dict(config["sgm"], num_disp=d)
    sgm.update(kw)
    return sgm


def _port_pair(sgm, fast, left, right):
    est = dt.StereoDepthEstimator(device="cpu")
    est.configure_sgbm(**sgm)
    est.core.fast_mode = fast
    est.left_source, est.right_source = left, right
    return est.estimate_depth()


@pytest.mark.parametrize("mode", ["sgbm_3way", "hh4", "sgbm", "hh"])
@pytest.mark.parametrize("config", ["sgbm_1080p_128d", "northstar_1080p_128d"])
def test_reference_equals_port(config, mode):
    cfg = spec.load_cell({"sgbm_1080p_128d": CELLS[0],
                          "northstar_1080p_128d": CELLS[1]}[config]).config
    sgm = _sgm(cfg, sgbm_mode=mode)
    for left, right in _pairs(11):
        disp, depth = _port_pair(sgm, cfg["fast_mode"], left, right)
        r_disp, r_depth = ref.stereo_depth(torch.from_numpy(left), torch.from_numpy(right),
                                           sgm, cfg["fast_mode"])
        assert np.array_equal(disp, r_disp.numpy())
        assert np.array_equal(depth, r_depth.numpy())
        assert (disp > 0).mean() > 0.5


def test_reference_equals_port_with_hole_filling():
    cfg = spec.load_cell(CELLS[0]).config
    sgm = _sgm(cfg, hole_filling=True)
    left, right = _pairs(12, n=1)[0]
    disp, depth = _port_pair(sgm, False, left, right)
    r_disp, r_depth = ref.stereo_depth(torch.from_numpy(left), torch.from_numpy(right),
                                       sgm, False)
    assert np.array_equal(disp, r_disp.numpy()) and np.array_equal(depth, r_depth.numpy())


def test_reference_equals_stream():
    """The stream facade's float16 depth, frame by frame."""
    cfg = load(STREAM).config
    sgm = _sgm(cfg)
    frames = scenes.drifting_frames(13, 3, 40, 112, 32, 3, SCENE, torch.device("cpu"))
    vid = dt.StereoDepthEstimatorVideo([f[0] for f in frames], [f[1] for f in frames],
                                       fast_mode=True, target_fps=0, depth_dtype="float16",
                                       device="cpu")
    vid.configure_sgbm(**sgm)
    got = list(vid.estimate_depth())
    assert len(got) == 3
    for (left, right), depth in zip(frames, got):
        _, r_depth = ref.stereo_depth(torch.from_numpy(left), torch.from_numpy(right), sgm, True)
        assert np.array_equal(depth, r_depth.to(torch.float16).numpy())


@pytest.mark.parametrize("cell", CELLS + (STREAM,))
def test_control_fails_the_check(cell):
    """The reference with its float32 stages in bfloat16, in the
    program's place, comes out not correct (benchmark/control.py reads the
    same at the cells' own size on the card)."""
    import control

    c = tiny(cell)
    for seed, values in control.readings(c, [3, 4, 5], torch.device("cpu")).items():
        assert any(values[k] > lim for k, lim in c.limits.items()), (seed, values)
        assert values["mismatch_share"] > 0.01


def test_scenes_follow_the_seed():
    a, b = _pairs(2**40 + 3), _pairs(2**40 + 3)
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    c = _pairs(2**40 + 4)
    assert not np.array_equal(a[0][0], c[0][0])
    assert not np.array_equal(a[0][0], a[1][0])
    left, right = a[0]
    assert left.dtype == np.uint8 and left.shape == (40, 112, 3)
    assert scenes.seed_sequence(-1).entropy == scenes.seed_sequence(2**64 - 1).entropy
