"""The PyTorch port's tools on the CPU (part 3 of the surface's tests;
tests/test_torch_surface.py says why they are split): convert_hf_checkpoint
(the reloaded forward bit-equal with --verify, and the port's forward
within 1e-4 of the max against JAX's converter on the same snapshot:
float32 sums in other orders), halo_sweep (its percentages equal to JAX's
tool's: JAX's tile_sharded_disparity on four CPU devices, measured by JAX's
seam_metrics), profile_kernels and the examples (they need a card
unless told otherwise).
"""

import os

import jax
import numpy as np
import pytest
import torch

from depthestimation_tpu import SGMConfig as JaxSGMConfig
from depthestimation_tpu.models import convert as jconvert
from depthestimation_tpu.parallel import shard as jshard
from depthestimation_tpu.parallel.mesh import make_mesh
from depthestimation_tpu.pipeline import raw_disparity as jax_raw_disparity
from depthestimation_torch.examples import mono as mono_example
from depthestimation_torch.examples import stereo, stereo_live
from depthestimation_torch.io.synthetic import synthesize_stereo_pair
from depthestimation_torch.models.mono import MonoDepthModel
from depthestimation_torch.tools import convert_hf_checkpoint, halo_sweep, profile_kernels
from test_torch_mono import rel_err, tiny_hf  # noqa: F401 (a fixture)
from test_torch_surface import ASSETS
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def test_convert_hf_checkpoint(tiny_hf, tmp_path, capsys):
    snapshot = tiny_hf[1]["safetensors"]
    out = str(tmp_path / "ckpt")
    assert convert_hf_checkpoint.main([snapshot, out, "--verify", "--device", "cpu"]) == 0
    assert "Verified: reloaded forward is bit-identical" in capsys.readouterr().out
    x = np.random.default_rng(1).uniform(0, 1, (1, 56, 70, 3)).astype(np.float32)
    jmodel = jconvert.load_hf_depth_anything(snapshot)
    want = np.asarray(jax.jit(jmodel.net.apply)({"params": jmodel.params}, x))
    with torch.no_grad():
        got = MonoDepthModel.load(out, device="cpu").net(torch.from_numpy(x))
    assert rel_err(got, want) <= 1e-4
    assert convert_hf_checkpoint.main([str(tmp_path), out, "--device", "cpu"]) == 2


def test_halo_sweep_equals_jax():
    """The port's sweep, tile by tile on one device, against JAX's tool:
    JAX's tile_sharded_disparity on a (1, 4, 1) mesh of CPU devices (halo
    rows exchanged between them) and JAX's whole-image raw_disparity,
    measured by JAX's seam_metrics."""
    from tools.halo_sweep import seam_metrics  # the JAX tool; it sets up JAX on import

    n, halos, h, w, d = 4, (4, 8), 64, 160, 16
    got = halo_sweep.sweep(h, w, d, n, halos, device="cpu", verbose=False)
    left, right, _ = synthesize_stereo_pair(w, h, d, seed=0)
    gl = jax.numpy.asarray(left[..., 0], jax.numpy.float32)
    gr = jax.numpy.asarray(right[..., 0], jax.numpy.float32)
    mesh = make_mesh((1, n, 1))
    for speckle in (0, 50):
        cfg = JaxSGMConfig(num_disp=d, sgbm_mode="hh4", use_pallas=False,
                           speckle_window_size=speckle)
        whole = jax.jit(lambda a, b: jax_raw_disparity(a, b, cfg))(gl, gr)
        for halo in halos:
            tiled = jax.jit(jshard.tile_sharded_disparity(mesh, cfg, halo=halo))(gl, gr)
            assert got[(speckle, halo)] == seam_metrics(tiled, whole, n), (speckle, halo)
    assert got[(0, 8)][1] < got[(0, 4)][1]  # a wider halo, fewer seam errors
    table = halo_sweep.table(got).splitlines()
    assert table[0] == "| speckle | halo | mismatch total % | mismatch at seams % |"
    assert len(table) == 2 + len(got)


def test_profile_kernels_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_kernels.main([])


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (stereo, stereo_live, mono_example):
        assert module.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stereo.run([os.path.join(ASSETS, "im0.png"), os.path.join(ASSETS, "im1.png"),
                    "--no-viz"])
