"""The PyTorch port's config, dtype rules, dispatch checks and import
hygiene, against the JAX package where it has a counterpart."""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from depthestimation_tpu import config as jconfig
from depthestimation_tpu.ops import pallas_sgm
from depthestimation_torch import config, StereoDepthEstimator, StereoPipeline
from depthestimation_torch.ops import cuda_sgm
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "depthestimation_torch",
    "depthestimation_torch.api",
    "depthestimation_torch.calib",
    "depthestimation_torch.config",
    "depthestimation_torch.pipeline",
    "depthestimation_torch.io.input",
    "depthestimation_torch.models.convert",
    "depthestimation_torch.models.dpt",
    "depthestimation_torch.models.mono",
    "depthestimation_torch.models.train",
    "depthestimation_torch.models.vit",
    "depthestimation_torch.ops.color",
    "depthestimation_torch.ops.costs",
    "depthestimation_torch.ops.cuda_build",
    "depthestimation_torch.ops.cuda_sgm",
    "depthestimation_torch.ops.depth",
    "depthestimation_torch.ops.filters",
    "depthestimation_torch.ops.remap",
    "depthestimation_torch.ops.sgm",
    "depthestimation_torch.ops.wls",
    "depthestimation_torch.ops.wta",
    "depthestimation_torch.parallel.mesh",
    "depthestimation_torch.parallel.shard",
]


def port_dict(cfg):
    return dataclasses.asdict(cfg)


def jax_dict(cfg):
    d = dataclasses.asdict(cfg)
    for k in config._JAX_ONLY_KEYS:
        d.pop(k)
    return d


@pytest.mark.parametrize(
    "kwargs,downscale",
    [
        ({}, 1.0),
        ({"num_disp": 280}, 0.5),  # rounds up to 144
        ({"num_disp": 64, "focal_length": 700.0, "doffs": 3.0,
          "baseline": 0.1, "cam_matrix_L": np.eye(3), "image_width": 640,
          "wls_filter": True}, 0.7),
    ],
)
def test_config_updated_matches_jax(kwargs, downscale):
    want = jconfig.SGMConfig().updated(downscale_factor=downscale, **kwargs)
    got = config.SGMConfig().updated(downscale_factor=downscale, **kwargs)
    assert port_dict(got) == jax_dict(want)
    assert (got.p1, got.p2, got.num_paths, got.invalid_disp) == (
        want.p1, want.p2, want.num_paths, want.invalid_disp)
    assert got.has_full_calibration() == want.has_full_calibration()
    # The JAX config converts through a plain dict, calib included.
    assert config.config_from_dict(dataclasses.asdict(want)) == got
    if kwargs.get("num_disp") == 280:
        assert got.num_disp == 144


def test_default_config_matches_jax():
    assert config.DEFAULT_CONFIG == config.SGMConfig()
    assert port_dict(config.DEFAULT_CONFIG) == jax_dict(jconfig.DEFAULT_CONFIG)


def test_parse_calib_file_matches_jax():
    path = os.path.join(REPO, "assets", "calib.txt")
    want = jconfig.parse_calib_file(path)
    got = config.parse_calib_file(path)
    assert got.keys() == want.keys()
    for k in want:
        if k == "sgbm_kwargs":
            assert got[k].keys() == want[k].keys()
            for kk in want[k]:
                np.testing.assert_array_equal(got[k][kk], want[k][kk])
        else:
            np.testing.assert_array_equal(got[k], want[k])


DTYPE_GRID = [
    dict(),
    dict(block_size=7, sgbm_mode="hh"),
    dict(block_size=11),
    dict(block_size=11, sgbm_mode="hh4"),
    dict(block_size=9, sgbm_mode="sgbm"),
    dict(block_size=13),
    dict(block_size=15),
    dict(prefilter_cap=63, block_size=7),
    dict(prefilter_cap=63, block_size=9, sgbm_mode="hh4"),
    dict(cost="census", block_size=11, sgbm_mode="hh"),
    dict(cost="census", block_size=41),
    dict(num_disp=256, block_size=3),
    dict(num_disp=64, min_disp=3),
    # Above 256 the kernels' wide variants take any D, as Pallas does.
    dict(num_disp=288),
    dict(num_disp=1024),
]


@pytest.mark.parametrize("kw", DTYPE_GRID)
def test_dtype_rules_match_pallas(kw):
    jcfg = jconfig.SGMConfig(**kw)
    cfg = config.SGMConfig(**kw)
    as_torch = {np.dtype("int16"): torch.int16, np.dtype("int32"): torch.int32}
    assert cuda_sgm._acc_dtype(cfg) == as_torch[np.dtype(pallas_sgm._acc_dtype(jcfg))]
    assert cuda_sgm._final_dtype(cfg) == as_torch[np.dtype(pallas_sgm._final_dtype(jcfg))]
    for shape in [(1080, 1920), (24, 128), (4, 400)]:
        assert cuda_sgm.kernels_supported(cfg, shape) == pallas_sgm.pallas_supported(
            jcfg, shape)


def test_final_dtype_int32_where_int16_wraps():
    cfg = config.SGMConfig(num_disp=32, sgbm_mode="hh", block_size=7)
    assert cfg.num_paths * (cfg.block_size ** 2 * 2 * cfg.prefilter_cap + cfg.p2) > 32767
    assert cuda_sgm._final_dtype(cfg) == torch.int32
    cfg = config.SGMConfig(block_size=11)
    assert cuda_sgm._acc_dtype(cfg) == torch.int32
    assert cuda_sgm._final_dtype(cfg) == torch.int32


@pytest.mark.parametrize(
    "kw,shape,match",
    [
        # Census costs at most 24 a pixel, so its window may be wider than
        # BT's (see test_default_config_supported) but not without end.
        (dict(cost="census", block_size=41), (64, 256), "census"),
        (dict(block_size=15), (64, 256), "int16 bounds"),
        (dict(block_size=7), (5, 256), "launch shapes"),
        (dict(num_disp=128), (64, 128), "int16 bounds"),
    ],
)
def test_unsupported_configs_raise(kw, shape, match):
    cfg = config.SGMConfig(**kw)
    with pytest.raises(NotImplementedError, match=match):
        cuda_sgm.check_supported(cfg, shape)
    with pytest.raises(NotImplementedError, match=match):
        cuda_sgm.sgm_disparity(torch.zeros(shape), torch.zeros(shape), cfg)


def test_default_config_supported():
    cuda_sgm.check_supported(config.SGMConfig(), (1080, 1920))
    for kw in (dict(sgbm_mode="hh4"), dict(sgbm_mode="sgbm"),
               dict(sgbm_mode="hh"), dict(cost="census"),
               dict(cost="census", block_size=15)):
        cuda_sgm.check_supported(config.SGMConfig(**kw), (1080, 1920))


def test_full_calibration_raises():
    """Full calibration takes the rectification path: an image whose size
    differs from the calibration's raises its RuntimeWarning (an error
    here, so nothing is resized to the calibration's 2964x1988)."""
    pipe = StereoPipeline(device="cpu")
    pipe.configure(**config.parse_calib_file(
        os.path.join(REPO, "assets", "calib.txt"))["sgbm_kwargs"])
    assert pipe.cfg.has_full_calibration()
    img = np.zeros((48, 96), np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        with pytest.raises(RuntimeWarning, match="calibration size"):
            pipe.estimate_depth(img, img)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoPipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoDepthEstimator()
    assert StereoDepthEstimator(device="cpu").core.device.type == "cpu"


def test_wrapper_rejects_other_devices():
    cfg = config.SGMConfig(num_disp=16)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_sgm.cost_volume(torch.zeros(8, 64, device="meta"),
                             torch.zeros(8, 64, device="meta"), cfg)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'msgpack') "
        "or m.startswith(('jax.', 'jaxlib', 'flax.', 'optax.', 'msgpack.', "
        "'depthestimation_tpu'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_c_signatures_match_sources():
    """cuda_build binds every C function of csrc/*.cu with its argument
    types (a pointer or the stream as c_void_p, a float as c_float, an int
    as c_int); a mismatch would pass pointers as ints, or drop an argument,
    on the card."""
    import ctypes
    import re

    from depthestimation_torch.ops import cuda_build

    found = {}
    for src in sorted(cuda_build._CSRC.glob("*.cu")):
        block = src.read_text().split('extern "C" {', 1)[1]
        for name, params in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", block, re.M):
            found[name] = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                           else ctypes.c_float if p.split()[0] == "float"
                           else ctypes.c_int for p in params.split(",")]
    assert found == cuda_build._SIGNATURES


def test_wide_ceiling():
    """Above 256 disparities the kernels hold a config only where one
    warp's ring and carry fit in a block's shared memory (cuda_sgm.
    wide_fits, the kernels' own test): up to 11,600 disparities with int16
    sums, 8,928 with int32; past it kernels_supported is False, so
    raw_disparity takes the float32 route. The constants it mirrors are the
    kernel source's."""
    import re

    from depthestimation_torch.ops import cuda_build

    src = (cuda_build._CSRC / "sgm_kernels.cu").read_text()
    assert re.findall(r"constexpr int kWideRing = (\d+);", src) == [str(cuda_sgm._WIDE_RING)]
    assert re.findall(r"constexpr size_t kMaxBlockSmem = (\d+);", src) == [
        str(cuda_sgm._WIDE_BLOCK_SMEM)]
    assert re.findall(r"constexpr int kWidePad = (\d+);", src) == ["8"]
    for kw, top, acc in ((dict(), 11600, torch.int16), (dict(block_size=11), 8928, torch.int32)):
        for d in (top, top + 16):
            cfg = config.SGMConfig(num_disp=d, **kw)
            assert cuda_sgm._acc_dtype(cfg) == acc
            shape = (cfg.block_size, d + cfg.min_disp + 1)
            assert cuda_sgm.kernels_supported(cfg, shape) is (d == top)
            assert cuda_sgm.wide_fits(d, acc) is (d == top)
        with pytest.raises(NotImplementedError, match="shared memory"):
            cuda_sgm.check_supported(config.SGMConfig(num_disp=top + 16, **kw),
                                     (cfg.block_size, top + 32))
    assert cuda_sgm.wide_fits(1024, torch.int32)
