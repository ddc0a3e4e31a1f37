"""The port's compiled-program caches against the JAX package's, on the
CPU: StereoPipeline's keys (JAX's jit cache keys, pipeline.py:248-345),
configure() dropping the other configs' entries, a temporal sequence with
a reset and an injected matcher, and the mono net's and the stream stats'
caches. On the CPU an entry is the eager function; the CUDA graphs are
held to the eager functions by tests/test_torch_graph_cache_cuda.py."""

import dataclasses

import numpy as np
import torch

from depthestimation_tpu import pipeline as jpipeline
import depthestimation_torch as dt
from depthestimation_torch import config, pipeline
from depthestimation_torch.models import dpt, mono, vit
from depthestimation_torch.ops import cuda_sgm

H, W, D = 24, 96, 16
# A small rig for the rectified entry (the JAX bench's mild rig, scaled).
_FX = 50.0
RIG = dict(cam_matrix_L=np.array([[_FX, 0, W / 2], [0, _FX, H / 2], [0, 0, 1]]),
           cam_matrix_R=np.array([[_FX, 0, W / 2], [0, _FX, H / 2], [0, 0, 1]]),
           image_width=W, image_height=H, baseline=0.12)
# Cheap to compile in JAX: fast mode and a short speckle window; the
# temporal smoother on, so the carry rides through the entries. Alpha 0.5
# keeps the blend exact in float32 in both packages: XLA contracts
# a * new + b * prev into a fused multiply-add, so at 0.4 its blend and
# torch's differ in the last bit on a few % of pixels. (WLS is held to JAX
# within a tolerance, tests/test_torch_rectify.py.)
FLAGS = dict(num_disp=D, speckle_window_size=8, temporal_alpha=0.5, focal_length=_FX,
             baseline=0.1)


def frames(n, seed, shape=(H, W)):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, shape).astype(np.float32) for _ in range(2))
            for _ in range(n)]


def pipelines(**kw):
    jp, tp = jpipeline.StereoPipeline(fast_mode=True), pipeline.StereoPipeline(
        fast_mode=True, device="cpu")
    jp.configure(**kw)
    tp.configure(**kw)
    assert config.config_from_dict(dataclasses.asdict(jp.cfg)) == tp.cfg
    return jp, tp


def _drop_rect_shape(key):
    """A rectified entry's key without its shape: JAX's holds the left
    image's shape there, the port's the raw pair's shapes and dtypes."""
    return key[:2] + key[3:] if key[0] == "rect" else key


def same_keys(jp, tp):
    """JAX's keys, with its config replaced by the port's (equal, as
    pipelines() checks), are the port's."""
    jax_keys = {_drop_rect_shape(tuple(tp.cfg if k is jp.cfg else k for k in key))
                for key in jp._jit_cache}
    return jax_keys == {_drop_rect_shape(key) for key in tp._graph_cache}


def test_cache_keys_match_jax():
    """The same (cfg, shape, fast_mode, downscale_factor, temporal) reuses
    one entry, a change in any part makes a new one, and after the same
    calls the port holds JAX's keys; on the CPU an entry is the eager
    function and launches nothing."""
    jp, tp = pipelines(**{**FLAGS, **RIG})
    getters = {"plain": ("_get_jitted", "_get_graphed"),
               "post": ("_get_post_jitted", "_get_post_graphed"),
               "rect": ("_get_rect_jitted", "_get_rect_graphed")}
    raw = ((H, W, 3), torch.uint8)
    seen = {}
    for what, shape, fast, ds, temporal in [
            ("plain", (H, W), True, 1.0, False), ("plain", (H, W), True, 1.0, False),
            ("plain", (H, W + 16), True, 1.0, False), ("plain", (H, W), False, 1.0, False),
            ("plain", (H, W), True, 0.5, False), ("plain", (H, W), True, 1.0, True),
            ("post", (H, W), True, 1.0, False), ("post", (H, W), True, 1.0, True),
            ("rect", (H, W, 3), True, 1.0, False), ("rect", (H, W, 3), True, 1.0, True)]:
        for p in (jp, tp):
            p.fast_mode, p.downscale_factor = fast, ds
        jget, tget = getters[what]
        getattr(jp, jget)(shape, temporal)
        tshape = (raw, raw) if what == "rect" else shape
        entry = getattr(tp, tget)(tshape, temporal)
        key = (what, shape, fast, ds, temporal)
        assert (entry is seen[key]) if key in seen else all(entry is not e for e in seen.values())
        seen[key] = entry
        assert not isinstance(entry, dt.graphs.CapturedCall)
    assert len(tp._graph_cache) == len(jp._jit_cache) == 9
    # The matcher alone, keyed ("matcher", cfg, shape), run on both.
    left, right = frames(1, seed=0)[0]
    want = np.asarray(jp.compute_disparity(left, right))
    got = tp.compute_disparity(left, right)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tp.compute_disparity(left, right) is not got
    assert same_keys(jp, tp)
    # A new config makes new entries (JAX keeps the old ones too).
    for p in (jp, tp):
        p.configure(num_disp=32)
        p.fast_mode, p.downscale_factor = True, 1.0
    assert tp._get_graphed((H, W)) is not seen[("plain", (H, W), True, 1.0, False)]
    jp._get_jitted((H, W))
    assert (tp.cfg, (H, W), True, 1.0, False) in tp._graph_cache
    assert (jp.cfg, (H, W), True, 1.0, False) in jp._jit_cache
    assert not any(cuda_sgm.LAUNCHES.values()) and not any(cuda_sgm.CALLS.values())


def test_configure_drops_other_configs():
    """configure() keeps the new config's entries only (a divergence from
    JAX, which keeps every entry: a graph's pool holds its frame's working
    set); reconfiguring to an equal config keeps them."""
    jp, tp = pipelines(**FLAGS)
    for p, get in ((jp, "_get_jitted"), (tp, "_get_graphed")):
        for temporal in (False, True):
            getattr(p, get)((H, W), temporal)
    old = dict(tp._graph_cache)
    tp.configure(**FLAGS)  # the same config again
    assert tp._graph_cache == old
    for p in (jp, tp):
        p.configure(num_disp=32)
    assert tp._graph_cache == {} and len(jp._jit_cache) == 2
    entry = tp._get_graphed((H, W))
    tp.configure(num_disp=16)
    assert tp._graph_cache == {}
    tp.configure(num_disp=32)
    assert tp._get_graphed((H, W)) is not entry


def test_sequence_with_reset_and_injected_matcher_matches_jax():
    """Five frames through process_pair_async on both packages: the
    temporal carry, a reset_temporal(), then an injected matcher (the
    reference's test seam) with the carry and another reset. Disparity bit
    for bit, depth at rtol 1e-5, and the same cache keys."""
    jp, tp = pipelines(**FLAGS)

    def fake(left, right):
        """A matcher stand-in on the 1/16 grid, from both images."""
        l, r = np.asarray(left), np.asarray(right)
        return (np.floor(l / 32.0) + (r % 16.0) / 16.0 + 2.0).astype(np.float32)

    pairs = frames(5, seed=1)
    for i, (left, right) in enumerate(pairs):
        if i in (2, 4):
            for p in (jp, tp):
                p.reset_temporal()
        if i == 3:
            jp.compute_disparity = fake
            tp.compute_disparity = fake
        want = [np.asarray(a) for a in jp.process_pair_async(left, right)]
        got = [t.numpy() for t in tp.process_pair_async(torch.tensor(left), torch.tensor(right))]
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"frame {i}")
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, err_msg=f"frame {i}")
    assert same_keys(jp, tp)
    assert len(tp._graph_cache) == 4


def test_mono_and_stream_stats_caches():
    """MonoDepthModel keeps one entry per batch shape (and TF32 flags),
    cleared by to_device, and its forward equals the net's; the stream's
    stats entry equals _disp_stats and the float16 cast."""
    torch.manual_seed(0)
    net = mono.MonoDepthNet(vit.ViTConfig(image_size=56, patch_size=14, hidden_size=64,
                                          num_layers=2, num_heads=2, out_layers=(0, 0, 1, 1)),
                            dpt.DPTConfig(features=32, reassemble_channels=(16, 16, 32, 32),
                                          head_features=16))
    model = mono.MonoDepthModel(net=net.eval())
    x = torch.rand(1, 28, 42, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        assert torch.equal(model._forward(x), net(x))
        model._forward(x)
        model._forward(torch.rand(1, 28, 28, 3))
    assert [k[0] for k in model._graph_cache] == [(1, 28, 42, 3), (1, 28, 28, 3)]
    model.to_device("cpu")
    assert model._graph_cache == {}

    vid = dt.StereoDepthEstimatorVideo(device="cpu", depth_dtype="float16")
    disp = torch.tensor(np.random.default_rng(2).integers(-1, 40, (H, W)), dtype=torch.float32)
    depth = torch.rand(H, W) * 10
    stats, cast = vid._frame_out(disp, depth)
    assert torch.equal(stats, vid._disp_stats(disp)) and torch.equal(cast, depth.half())
    vid.depth_dtype = "float32"
    assert vid._frame_out(disp, depth)[1] is depth
    assert vid._frame_out(disp, None)[1] is None
    assert sorted(vid._stats_cache) == [((H, W),), ((H, W), (H, W))]
