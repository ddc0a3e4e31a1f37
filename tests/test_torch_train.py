"""The port's mono training step (depthestimation_torch/models/train.py),
predict_sharded and the JAX checkpoint reader, against the JAX package on
the CPU.

The net is tests/test_mono.py's tiny one (56 px, hidden 64, 2 heads, 2
layers), with tests/test_torch_mono.py's numpy-seeded weights carried to
both packages, and the head's output bias set to 2, which puts every
prediction above 0.1 (checked). At a random init many outputs sit at the
head's final ReLU, where the gradient is discontinuous: an output of 1e-8
on one side and 0 on the other weighs 1 / (pred + 1e-6) = 1e6 times in
SiLog's gradient on one side only, so the gradients of two correct
implementations differ by up to tens of percent of their max.

JAX's train step is compiled once, at mesh (1, 1, 1). One launch of four
gloo ranks (tests/gloo_launch.py) runs the data 2 x model 2 cases while
this process computes JAX's steps. Tolerances, with their reasons:
- loss: 1e-5 relative (float32 sums in another order; measured ~2e-7);
- gradients: per parameter, max abs err <= 1e-4 of the max |g| (the
  convolutions' backward sums in other orders; measured <= 1.7e-6). JAX's
  gradients are read from its AdamW state after one step, mu = 0.1 g;
- weights after a step: within 1e-2 * lr wherever the reference gradient
  is above the gradient tolerance. Adam's first step moves a weight by
  lr * g / (|g| + 1e-8), about lr * sign(g): where g is float noise (the
  key bias's gradient is 0 in exact arithmetic, as softmax ignores a
  shift shared by every key), its sign decides, in either package, so
  there the weights are held within 2 * lr, the most two such steps can
  differ;
- the data 2 x model 2 step against one rank holding the whole batch:
  the same tolerances; predict_sharded: 1e-5 of the max.
Past the first steps the two packages drift apart as two JAX meshes do
(0.6 % at step 1 and 7 % at step 2 between meshes (1,1,1) and (2,1,2)),
so a longer run is held only to a falling loss.
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthestimation_tpu.models import mono as jmono
from depthestimation_tpu.models import train as jtrain
from depthestimation_tpu.models.dpt import DPTConfig as JDPTConfig
from depthestimation_tpu.models.vit import ViTConfig as JViTConfig
from depthestimation_tpu.parallel.mesh import make_mesh as jax_mesh
from depthestimation_torch.models import convert, mono, train
from depthestimation_torch.models.dpt import DPTConfig
from depthestimation_torch.models.vit import ViTConfig
from depthestimation_torch.parallel.mesh import make_mesh

import gloo_launch
from test_torch_mono import TINY, TINY_DPT, numpy_params, rel_err
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

LR = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4
WEIGHT_ATOL = 1e-2 * LR
NOISE_ATOL = 2 * LR * (1 + 1e-3)  # two first Adam steps of opposite sign
HW = (56, 56)

RANK_SCRIPT = r'''
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from depthestimation_torch.models import mono, train
from depthestimation_torch.models.dpt import DPTConfig
from depthestimation_torch.models.vit import ViTConfig
from depthestimation_torch.parallel import mesh as pm

rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
pm.initialize_distributed(store, world, rank, device="cpu")
inp = dict(np.load(f"{work}/inputs.npz"))
cfg = json.load(open(f"{work}/net.json"))
net = mono.MonoDepthNet(ViTConfig(**{**cfg["vit"], "out_layers": tuple(cfg["vit"]["out_layers"])}),
                        DPTConfig(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in cfg["dpt"].items()}))
net.load_state_dict(torch.load(f"{work}/state.pt", weights_only=True))
out = {}

grid = pm.make_mesh((2, 1, 2), device="cpu")
local, opt, shardings = train.make_sharded_train_state(net, grid, (56, 56),
                                                        float(inp["lr"]), seed=None)
out["local_qkv_rows"] = torch.tensor(local.backbone.block_0.attn.qkv.weight.shape[0])
step = train.make_train_step(local, opt, grid, shardings)
losses = [step(inp["images"], inp["targets"])]
grads = train.gather_params({n: p.grad for n, p in local.named_parameters()}, grid, shardings)
weights = train.gather_params({n: p.detach() for n, p in local.named_parameters()}, grid,
                              shardings)
losses += [step(inp["images"], inp["targets"]) for _ in range(2)]
out["losses"] = torch.stack(losses)
out.update({"grad:" + n: g for n, g in grads.items()})
out.update({"weight:" + n: w for n, w in weights.items()})

# model 4 over the tiny net's 2 heads: JAX's contiguous qkv / proj layout.
grid4 = pm.make_mesh((1, 1, 4), device="cpu")
local, opt, shardings = train.make_sharded_train_state(net, grid4, (56, 56),
                                                        float(inp["lr"]), seed=None)
attn = local.backbone.block_0.attn
out["model4:local_qkv_rows"] = torch.tensor(attn.qkv.weight.shape[0])
out["model4:num_heads"] = torch.tensor(attn.num_heads)
step = train.make_train_step(local, opt, grid4, shardings)
losses = []
for k in (1, 2):
    losses.append(step(inp["images"], inp["targets"]))
    for kind, get in (("grad", lambda p: p.grad), ("weight", lambda p: p.detach())):
        full = train.gather_params({n: get(p) for n, p in local.named_parameters()}, grid4,
                                   shardings)
        out.update({f"model4:{kind}{k}:{n}": t for n, t in full.items()})
out["model4:losses"] = torch.stack(losses)

model = mono.MonoDepthModel(net=net.eval())
out["pred"] = torch.from_numpy(model.predict_sharded(inp["images"], grid))
out["model4:pred"] = torch.from_numpy(model.predict_sharded(inp["images"], grid4))
# New weights loaded into the net: the cached sharded predict slices them again.
with torch.no_grad():
    net.head.head_out.bias.add_(0.5)
out["pred_new_weights"] = torch.from_numpy(model.predict_sharded(inp["images"], grid))

np.savez(f"{work}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
'''


def port_net(state):
    net = mono.MonoDepthNet(ViTConfig(**TINY), DPTConfig(**TINY_DPT))
    net.load_state_dict(state)
    return net


@pytest.fixture(scope="module")
def inputs():
    """JAX's params from a numpy seed (the head's output bias at 2), and a
    batch of 4 with an invalid band in the first target."""
    jnet = jmono.MonoDepthNet(JViTConfig(**TINY), JDPTConfig(**TINY_DPT))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    params = numpy_params(nn.meta.unbox(shapes)["params"])
    params["head"]["head_out"]["bias"] = np.full_like(params["head"]["head_out"]["bias"], 2.0)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (4, *HW, 3)).astype(np.float32)
    targets = rng.uniform(0.5, 2.0, (4, *HW)).astype(np.float32)
    targets[0, :8] = 0.0
    return jnet, params, images, targets


def test_predictions_clear_of_the_relu(inputs):
    """The precondition of the gradient tolerances (module docstring)."""
    net = port_net(convert.from_flax_params(inputs[1]))
    with torch.no_grad():
        assert float(net(torch.from_numpy(inputs[2])).min()) > 0.1


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Start the four ranks (data 2 x model 2) on the same weights and
    batch; the first test that reads their results waits."""
    _, params, images, targets = inputs
    work = tmp_path_factory.mktemp("gloo_train")
    np.savez(work / "inputs.npz", images=images, targets=targets, lr=np.float64(LR))
    torch.save(convert.from_flax_params(params), work / "state.pt")
    with open(work / "net.json", "w") as f:
        json.dump({"vit": TINY, "dpt": TINY_DPT}, f)
    run = gloo_launch.start(RANK_SCRIPT, str(work))
    yield run
    run.close()


@pytest.fixture(scope="module")
def rank_out(ranks):
    ranks.wait()
    return [dict(np.load(os.path.join(ranks.workdir, f"rank{r}.npz"))) for r in range(4)]


@pytest.fixture(scope="module")
def jax_steps(inputs, ranks):
    """Two steps of JAX's make_train_step at mesh (1, 1, 1) from `inputs`
    (the ranks are started first and run meanwhile)."""
    jnet, params, images, targets = inputs
    mesh = jax_mesh((1, 1, 1))
    tx = optax.adamw(LR)
    step = jtrain.make_train_step(jnet, tx, mesh, jtrain.param_shardings_for(jnet, mesh, HW))
    p0 = jax.tree.map(jnp.asarray, params)
    p1, s1, loss0 = step(p0, tx.init(p0), images, targets)
    p2, _, loss1 = step(p1, s1, images, targets)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    adam = s1[0]
    return dict(loss0=float(loss0), loss1=float(loss1),
                grads=convert.from_flax_params(as_np(jax.tree.map(lambda m: m / 0.1, adam.mu))),
                params1=as_np(p1), params2=as_np(p2),
                adam=(int(adam.count), as_np(adam.mu), as_np(adam.nu)))


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank mesh on this process (its own gloo group), torn down with
    the module."""
    mesh = make_mesh((1, 1, 1), device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def port_step(inputs, one_rank):
    """One step of the port's make_train_step on one rank from `inputs`."""
    _, params, images, targets = inputs
    net = port_net(convert.from_flax_params(params))
    local, opt, shardings = train.make_sharded_train_state(net, one_rank, HW, LR, seed=None)
    step = train.make_train_step(local, opt, one_rank, shardings)
    loss = step(images, targets)
    named = dict(local.named_parameters())
    return dict(loss=float(loss), grads={n: p.grad.clone() for n, p in named.items()},
                weights={n: p.detach().clone() for n, p in named.items()},
                capturable=opt.defaults["capturable"], entries=list(step.graph_cache.values()))


def grad_errors(got, want):
    return {n: rel_err(got[n], want[n]) for n in want}


def check_weights(got, want, grads):
    """got/want: {name: weights after a step}; grads: the reference
    gradient(s) that decide which weights are well determined."""
    for name, w in want.items():
        g = [torch.as_tensor(np.asarray(x[name])) for x in grads]
        firm = torch.stack([x.abs() > GRAD_REL * x.abs().max() for x in g]).all(0)
        diff = (torch.as_tensor(np.asarray(got[name])) - torch.as_tensor(np.asarray(w))).abs()
        assert not firm.any() or float(diff[firm].max()) <= WEIGHT_ATOL, name
        assert float(diff.max()) <= NOISE_ATOL, name


def test_silog_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0.1, 3.0, (2, 9, 7)).astype(np.float32)
    target = rng.uniform(0.5, 2.0, (2, 9, 7)).astype(np.float32)
    valid = rng.uniform(size=(2, 9, 7)) > 0.3
    for lam in (0.5, 1.0, 0.0):
        want = float(jtrain.silog_loss(jnp.asarray(pred), jnp.asarray(target),
                                       jnp.asarray(valid), lam=lam))
        got = float(train.silog_loss(torch.tensor(pred), torch.tensor(target),
                                     torch.tensor(valid), lam=lam))
        assert abs(got - want) <= LOSS_REL * abs(want), lam


def test_silog_loss_scale_invariance_and_empty_mask():
    pred = torch.full((4, 4), 2.0)
    valid = torch.ones((4, 4), dtype=torch.bool)
    assert float(train.silog_loss(pred, pred, valid)) == pytest.approx(0.0, abs=1e-9)
    # lam=1 leaves a global scale free.
    assert float(train.silog_loss(pred * 3.0, pred, valid, lam=1.0)) == pytest.approx(
        0.0, abs=1e-6)
    # No valid pixel: n is held at 1 and every d is 0, as in JAX.
    none = torch.zeros((4, 4), dtype=torch.bool)
    want = float(jtrain.silog_loss(jnp.full((4, 4), 6.0), jnp.full((4, 4), 2.0),
                                   jnp.zeros((4, 4), bool)))
    assert float(train.silog_loss(pred * 3.0, pred, none)) == want == 0.0


def test_step0_loss_matches_jax(jax_steps, port_step):
    """The step's loss; on a CPU mesh AdamW is not capturable (the card's
    is, for the step's CUDA graph) and the step runs eagerly."""
    assert abs(port_step["loss"] - jax_steps["loss0"]) <= LOSS_REL * abs(jax_steps["loss0"])
    assert port_step["capturable"] is False
    assert [e.__name__ for e in port_step["entries"]] == ["local_step"]


def test_gradients_match_jax(jax_steps, port_step):
    errs = grad_errors(port_step["grads"], jax_steps["grads"])
    assert set(errs) == set(port_step["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])


def test_weights_after_one_step_match_jax(jax_steps, port_step):
    want = convert.from_flax_params(jax_steps["params1"])
    check_weights(port_step["weights"], want, [jax_steps["grads"]])


def test_second_step_from_carried_optax_state(inputs, jax_steps, one_rank):
    """JAX's weights and AdamW moments after step 1 carried into the port
    (from_flax_params, load_optax_adam_state): step 2 against JAX's. A
    second load copies into the state's tensors (a captured step replays
    onto them) and overwrites what they held."""
    _, _, images, targets = inputs
    net = port_net(convert.from_flax_params(jax_steps["params1"]))
    local, opt, shardings = train.make_sharded_train_state(net, one_rank, HW, LR, seed=None)
    count, mu, nu = jax_steps["adam"]
    convert.load_optax_adam_state(opt, local, count, mu, nu)
    held = [t for s in opt.state.values() for t in s.values()]
    for t in held:
        t.zero_()
    convert.load_optax_adam_state(opt, local, count, mu, nu)
    assert all(a is b for a, b in zip(held, (t for s in opt.state.values() for t in s.values())))
    loss = float(train.make_train_step(local, opt, one_rank, shardings)(images, targets))
    assert abs(loss - jax_steps["loss1"]) <= LOSS_REL * abs(jax_steps["loss1"])
    grads = {n: p.grad for n, p in local.named_parameters()}
    check_weights({n: p.detach() for n, p in local.named_parameters()},
                  convert.from_flax_params(jax_steps["params2"]),
                  [jax_steps["grads"], grads])
    assert all(float(s["step"]) == 2 for s in opt.state.values())


def test_loss_falls_over_steps(inputs, one_rank, rank_out):
    """Three steps from the same weights, on one rank and on the four:
    only a falling loss is asked of a longer run."""
    _, params, images, targets = inputs
    local, opt, shardings = train.make_sharded_train_state(
        port_net(convert.from_flax_params(params)), one_rank, HW, LR, seed=None)
    step = train.make_train_step(local, opt, one_rank, shardings)
    losses = [float(step(images, targets)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    four = rank_out[0]["losses"]
    assert np.isfinite(four).all() and four[-1] < four[0], four


def test_seeded_train_state_keeps_the_callers_net(inputs, one_rank):
    """seed=3 draws the weights as MonoDepthModel.from_configs(seed=3) does,
    on a copy: the caller's net keeps its own."""
    net = port_net(convert.from_flax_params(inputs[1]))
    before = {n: p.clone() for n, p in net.state_dict().items()}
    local = train.make_sharded_train_state(net, one_rank, HW, LR, seed=3)[0]
    want = mono.MonoDepthModel.from_configs(ViTConfig(**TINY), DPTConfig(**TINY_DPT), seed=3,
                                            device="cpu").net.state_dict()
    for n, p in net.state_dict().items():
        assert torch.equal(p, before[n]), n
    for n, p in local.state_dict().items():
        assert torch.equal(p, want[n]), n


@pytest.mark.parametrize("what", ["loss", "gradients", "weights"])
def test_data2_model2_step_matches_one_rank(rank_out, port_step, what):
    """data 2 x model 2 over gloo against one rank holding the whole batch:
    the global SiLog, gradients summed over 'data', heads split over
    'model'."""
    for r in range(1, 4):
        np.testing.assert_array_equal(rank_out[r]["losses"], rank_out[0]["losses"])
    out = rank_out[0]
    if what == "loss":
        assert abs(float(out["losses"][0]) - port_step["loss"]) <= LOSS_REL * abs(
            port_step["loss"])
    elif what == "gradients":
        got = {n: out["grad:" + n] for n in port_step["grads"]}
        errs = grad_errors(got, port_step["grads"])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_REL, (worst, errs[worst])
    else:
        got = {n: out["weight:" + n] for n in port_step["weights"]}
        check_weights(got, port_step["weights"], [port_step["grads"]])
    # Each model rank held one of the two heads: q, k and v rows of one head.
    assert int(out["local_qkv_rows"]) == 3 * TINY["hidden_size"] // 2


def test_predict_sharded(inputs, rank_out, one_rank):
    """predict_sharded at data 2 x model 2 within 1e-5 of the net's own
    forward, also after new weights were loaded into the net (the cached
    sharded predict takes its slices again); at one rank equal to it bit
    for bit."""
    _, params, images, _ = inputs
    net = port_net(convert.from_flax_params(params)).eval()
    new = port_net(convert.from_flax_params(params)).eval()
    with torch.no_grad():
        want = net(torch.from_numpy(images)).numpy()
        new.head.head_out.bias.add_(0.5)
        want_new = new(torch.from_numpy(images)).numpy()
    for r in range(4):
        assert rel_err(rank_out[r]["pred"], want) <= 1e-5
        assert rel_err(rank_out[r]["pred_new_weights"], want_new) <= 1e-5
    got = mono.MonoDepthModel(net=net).predict_sharded(images, one_rank)
    np.testing.assert_array_equal(got, want)


class _MeshShape:
    """What param_shardings_for reads of a mesh: its axis names and sizes."""

    mesh_dim_names = ("data", "tile", "model")

    def __init__(self, model):
        self.shape = (1, 1, model)

    def size(self, dim):
        return self.shape[dim]


@pytest.mark.parametrize("what", ["loss", "gradients", "weights", "second_step",
                                  "predict_sharded"])
def test_model4_contiguous_layout_matches_jax(inputs, rank_out, jax_steps, what):
    """model 4 over the tiny net's 2 heads (mesh (1, 1, 4), JAX's
    contiguous qkv / proj layout: qkv's output all-gathered, every head on
    every rank) against JAX's steps at (1, 1, 1): the loss, the gathered
    gradients and weights of the first step, the second step, and
    predict_sharded against the net's own forward, with the module's
    tolerances. The four ranks hold the same gathered tensors bit for bit,
    so the replicated parameters stayed equal across the 'model' ranks."""
    keys = [k for k in rank_out[0] if k.startswith("model4:")]
    for r in range(1, 4):
        for k in keys:
            np.testing.assert_array_equal(rank_out[r][k], rank_out[0][k], err_msg=k)
    out = rank_out[0]

    def tensors(kind):
        prefix = f"model4:{kind}:"
        return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}

    if what == "loss":
        got, want = float(out["model4:losses"][0]), jax_steps["loss0"]
        assert abs(got - want) <= LOSS_REL * abs(want)
    elif what == "gradients":
        errs = grad_errors(tensors("grad1"), jax_steps["grads"])
        assert set(errs) == set(tensors("grad1"))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_REL, (worst, errs[worst])
    elif what == "weights":
        check_weights(tensors("weight1"), convert.from_flax_params(jax_steps["params1"]),
                      [jax_steps["grads"]])
    elif what == "second_step":
        got, want = float(out["model4:losses"][1]), jax_steps["loss1"]
        assert abs(got - want) <= LOSS_REL * abs(want)
        check_weights(tensors("weight2"), convert.from_flax_params(jax_steps["params2"]),
                      [jax_steps["grads"], tensors("grad2")])
    else:
        net = port_net(convert.from_flax_params(inputs[1])).eval()
        with torch.no_grad():
            want = net(torch.from_numpy(inputs[2])).numpy()
        assert rel_err(out["model4:pred"], want) <= 1e-5


def test_model_axis_must_divide_heads(rank_out):
    """The 'model' axis must divide what JAX splits, the hidden and MLP
    widths (64 and 256), and need not divide the heads: the tiny net's 2
    heads take model = 4 in JAX's contiguous layout (run on the four gloo
    ranks, every head on every rank), and model = 3 raises ValueError, as
    JAX's make_sharded_train_state does."""
    net = mono.MonoDepthNet(ViTConfig(**TINY), DPTConfig(**TINY_DPT))
    for model in (3, 5, 6):
        with pytest.raises(ValueError, match="hidden width"):
            train.param_shardings_for(net, _MeshShape(model))
    for model in (1, 2, 4, 8):
        qkv = train.param_shardings_for(net, _MeshShape(model))["backbone.block_1.attn.qkv.bias"]
        assert qkv == ("model", 0)
        assert isinstance(qkv, train._ByHeads) == (TINY["num_heads"] % model == 0), model
    out = rank_out[0]
    assert int(out["model4:local_qkv_rows"]) == 3 * TINY["hidden_size"] // 4
    assert int(out["model4:num_heads"]) == TINY["num_heads"]


def test_param_shardings_layout(one_rank):
    net = mono.MonoDepthNet(ViTConfig(**TINY), DPTConfig(**TINY_DPT))
    specs = train.param_shardings_for(net, one_rank)
    assert set(specs) == {n for n, _ in net.named_parameters()}
    split = {n: s for n, s in specs.items() if s is not None}
    assert split == {
        f"backbone.block_{i}.{m}": ("model", dim)
        for i in range(TINY["num_layers"])
        for m, dim in (("attn.qkv.weight", 0), ("attn.qkv.bias", 0), ("attn.proj.weight", 1),
                       ("mlp.fc1.weight", 0), ("mlp.fc1.bias", 0), ("mlp.fc2.weight", 1))}


def test_jax_msgpack_checkpoint_loads(inputs, tmp_path):
    """JAX's save() of the tiny net, read by the port's load() without
    msgpack or flax: the same weights, and the forward within 1e-4 of JAX's
    max."""
    jnet, params, images, _ = inputs
    jmono.MonoDepthModel(net=jnet, params=params, _jit_cache={}).save(str(tmp_path))
    model = mono.MonoDepthModel.load(str(tmp_path), device="cpu")
    for name, t in convert.from_flax_params(params).items():
        assert torch.equal(model.net.state_dict()[name], t), name
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, images[:1]))
    with torch.no_grad():
        got = model.net(torch.from_numpy(images[:1]))
    assert rel_err(got, want) <= 1e-4


def test_read_flax_msgpack_types():
    from flax.serialization import msgpack_serialize

    tree = {"a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "count": np.int32(7), "empty": np.zeros((0, 2), np.int16)},
            "b": [1, -3, 300, 70000, -200, 2.5, None, True, "x" * 40],
            "c": np.arange(70000, dtype=np.float64)}
    got = convert.read_flax_msgpack(msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"]["kernel"], tree["a"]["kernel"])
    assert got["a"]["count"] == 7 and got["a"]["count"].dtype == np.int32
    assert got["a"]["empty"].shape == (0, 2) and got["a"]["empty"].dtype == np.int16
    assert got["b"] == tree["b"]
    np.testing.assert_array_equal(got["c"], tree["c"])
    with pytest.raises(ValueError, match="trailing"):
        convert.read_flax_msgpack(msgpack_serialize(tree) + b"\x00")



