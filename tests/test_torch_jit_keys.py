"""The keys of the port's last three compiled-program caches against the
JAX package's jit caches, on the CPU: make_train_step's train_step,
MonoDepthModel.predict_sharded (its "sharded" entry and the per-shape
apply inside), and batch_pipeline's run. After the same calls, the port
holds one entry where JAX compiled once, and as many entries as JAX's
jitted function holds compiled programs (`_cache_size()`). On the CPU an
entry is the eager function; the CUDA graphs are held to the eager
functions by tests/test_torch_train_cuda.py.

At most 4 tests: the suite's scheduler deals files with more tests first,
and this file must not run ahead of the interpret-mode Pallas tests
(ROADMAP, "The tier-1 clock").
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthestimation_tpu.config import SGMConfig as JConfig
from depthestimation_tpu.models import mono as jmono
from depthestimation_tpu.models import train as jtrain
from depthestimation_tpu.models.dpt import DPTConfig as JDPTConfig
from depthestimation_tpu.models.vit import ViTConfig as JViTConfig
from depthestimation_tpu.parallel import shard as jshard
from depthestimation_tpu.parallel.mesh import make_mesh as jax_mesh
from depthestimation_torch.config import SGMConfig
from depthestimation_torch.models import convert, mono, train
from depthestimation_torch.models.dpt import DPTConfig
from depthestimation_torch.models.vit import ViTConfig
from depthestimation_torch.parallel import shard
from depthestimation_torch.parallel.mesh import destroy_process_group, make_mesh
from test_torch_mono import TINY, TINY_DPT, numpy_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

HW = (28, 28)
F32 = torch.float32


def closure(fn, name):
    """A variable that fn closes over (JAX's jitted inner functions)."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


@pytest.fixture(scope="module")
def nets():
    """JAX's tiny net with numpy-seeded params and the port's net with the
    same weights; batches of 4 and 2."""
    jnet = jmono.MonoDepthNet(JViTConfig(**TINY), JDPTConfig(**TINY_DPT))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    params = numpy_params(nn.meta.unbox(shapes)["params"])
    net = mono.MonoDepthNet(ViTConfig(**TINY), DPTConfig(**TINY_DPT))
    net.load_state_dict(convert.from_flax_params(params))
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (4, *HW, 3)).astype(np.float32)
    targets = rng.uniform(0.5, 2.0, (4, *HW)).astype(np.float32)
    return jnet, params, net, images, targets


@pytest.fixture(scope="module")
def meshes():
    mesh = make_mesh((1, 1, 1), device="cpu")
    yield jax_mesh((1, 1, 1)), mesh
    destroy_process_group()


def test_train_step_keys_match_jax(nets, meshes):
    """Batches of 4, 4, 4, 2 and 4: past its first state JAX compiles
    train_step once a batch shape, and the port holds one entry a batch
    shape, keyed by the images' and targets' (shape, dtype) and the TF32
    flags; on the CPU an entry is the eager step. (JAX's first state is a
    key of its own: jax.jit(tx.init) lays optax's step count out without
    the mesh's axes, a step lays it out with them.)"""
    jnet, params, net, images, targets = nets
    jmesh, mesh = meshes
    tx = optax.adamw(1e-4)
    jshardings = jtrain.param_shardings_for(jnet, jmesh, HW)
    jstep = jtrain.make_train_step(jnet, tx, jmesh, jshardings)
    local, opt, shardings = train.make_sharded_train_state(net, mesh, HW, 1e-4, seed=None)
    step = train.make_train_step(local, opt, mesh, shardings)
    # Laid out as make_sharded_train_state lays out JAX's state (the
    # shardings are part of jit's key).
    p = jax.device_put(params, jshardings)
    s = jax.jit(tx.init)(p)
    sizes = []
    for n in (4, 4, 4, 2, 4):
        p, s, _ = jstep(p, s, images[:n], targets[:n])
        step(images[:n], targets[:n])
        sizes.append((closure(jstep, "train_step")._cache_size(), len(step.graph_cache)))
    assert sizes == [(1, 1), (2, 1), (2, 1), (3, 2), (3, 2)]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    assert list(step.graph_cache) == [
        (((n, *HW, 3), F32), ((n, *HW), F32), *tf32) for n in (4, 2)]
    assert all(getattr(e, "__name__", "") == "local_step" for e in step.graph_cache.values())


def test_sharded_predict_keys_match_jax(nets, meshes):
    """MonoDepthModel.predict_sharded keeps one sharded predict per
    (mesh, image shape), JAX's ("sharded", mesh, shape) with the data
    axis, and inside it one entry per batch shape, as JAX's jitted apply
    compiles once per batch shape; both return the same depths."""
    jnet, params, net, images, _ = nets
    jmesh, mesh = meshes
    jmodel = jmono.MonoDepthModel(net=jnet, params=params, _jit_cache={})
    model = mono.MonoDepthModel(net=net.eval())
    for n in (4, 2, 4):
        want = jmodel.predict_sharded(images[:n], jmesh)
        got = model.predict_sharded(images[:n], mesh)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert list(jmodel._jit_cache) == [("sharded", jmesh, (*HW, 3))]
    assert list(model._graph_cache) == [("sharded", mesh, (*HW, 3), "data")]
    (jfn,), (predict,) = jmodel._jit_cache.values(), model._graph_cache.values()
    assert closure(jfn, "apply")._cache_size() == len(predict.graph_cache) == 2
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    assert list(predict.graph_cache) == [(((n, *HW, 3), F32), *tf32) for n in (4, 2)]


def test_batch_pipeline_keys_match_jax(meshes):
    """Batches of 2, 2 and 1 integer frames: JAX compiles run twice and the
    port holds two entries, keyed (cfg, local batch shape,
    downscale_factor, fast_mode, the tile layout), each equal to JAX's
    results bit for bit."""
    jmesh, mesh = meshes
    kw = dict(num_disp=16, speckle_window_size=8, focal_length=100.0, baseline=0.1)
    jrun = jshard.batch_pipeline(jmesh, JConfig(**kw), fast_mode=True)
    cfg = SGMConfig(**kw)
    run = shard.batch_pipeline(mesh, cfg, fast_mode=True)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 2, 24, 96)).astype(np.float32)
    sizes = []
    for n in (2, 2, 1):
        want = jrun(frames[0, :n], frames[1, :n])
        got = run(*(torch.from_numpy(f[:n]) for f in frames))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        sizes.append((jrun._cache_size(), len(run.graph_cache)))
    assert sizes == [(1, 1), (1, 1), (2, 2)]
    assert list(run.graph_cache) == [(cfg, (n, 24, 96), 1.0, True, (1, 0, shard.DEFAULT_HALO))
                                     for n in (2, 1)]
    assert all(e is run.eager for e in run.graph_cache.values())
