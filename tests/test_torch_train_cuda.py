"""The training step and the parallel layer on the card, over an NCCL
group of one rank (mesh (1, 1, 1)), against the CPU.

- One make_train_step of the tiny net (tests/test_mono.py's widths,
  seeded weights, the head's output bias at 2 so that every prediction is
  clear of the final ReLU's kink, checked; see tests/test_torch_train.py)
  against the same step on the CPU,
  TF32 off: the loss to 1e-5 relative, gradients per parameter to 1e-4
  of their max |g|, weights to 1e-2 * lr where the CPU's gradient is above
  that tolerance and to 2 * lr elsewhere (float32 sums in other orders on
  the two devices; Adam's first step moves a weight by about lr * sign(g)).
- A few steps with a falling loss; predict_sharded within 1e-4 of the
  CPU's forward (TF32 off), and equal to the card's own forward.
- The CUDA graphs of the train step, the sharded predict and
  batch_pipeline (the first call with a key runs eagerly and captures,
  later calls replay): STEPS graphed steps, each against an eager step
  from the same copied state, TF32 off, at TOL, with AdamW capturable and
  its step count on the card advancing on every replay; predict replays
  within MONO_TOL of its eager run; batch_pipeline's replays equal to its
  eager run bit for bit; a step with a host synchronisation in it
  raising at its capture.
- batch_pipeline on 2 small frames equal bit for bit to the single-pair
  path on the card, whose disparity equals the CPU's; disp_sharded_sgm
  equal to the matcher through the kernels; the tile function on the card
  equal to the CPU's, and tile_sharded_disparity to it.
- With four GPUs: `small` (6 heads) at mesh (1, 1, 4) over NCCL, one
  process per GPU, in JAX's contiguous qkv / proj layout, against the
  one-rank step on this process's mesh, with chip_smoke.py phase 3g's
  holds: one step at 4x518x518 (TF32 off, the head's output bias at 2)
  under SMALL_TOL, the replicated parameters equal across the 'model'
  ranks after it, and predict_sharded at 2x518x518 within 1e-5 of the
  max of the single forward; then a replay of the step, and the group
  ended by mesh.destroy_process_group with both graphs alive (NCCL's
  teardown waits for live graphs that hold its work: the ranks must end
  within RANKS_S).
- Optimizer state loaded after a capture: load_optax_adam_state copies
  into the captured tensors (the graph replays on), torch's
  load_state_dict and a new lr make the step capture again, each step
  against step.eager from the same state; graphs.release_collective_
  graphs drops the graphs, and the next call captures again.

Every test here needs an NVIDIA GPU and skips without one. This file
imports nothing of JAX; on a machine with a card and no JAX, run it
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_train_cuda.py
"""

import copy
import time

import numpy as np
import pytest
import torch

from depthestimation_torch.config import SGMConfig
from depthestimation_torch.graphs import CapturedCall
from depthestimation_torch.models import train
from depthestimation_torch.models.dpt import DPTConfig
from depthestimation_torch.models.mono import MonoDepthModel
from depthestimation_torch.models.vit import ViTConfig
from depthestimation_torch.parallel import shard
from depthestimation_torch.pipeline import postprocess_and_depth, raw_disparity

pytestmark = pytest.mark.cuda

TINY = dict(image_size=56, patch_size=14, hidden_size=64, num_layers=2,
            num_heads=2, out_layers=(0, 0, 1, 1))
TINY_DPT = dict(features=32, reassemble_channels=(16, 16, 32, 32), head_features=16)
LR = 1e-4
TOL = {"loss": 1e-5, "grad": 1e-4, "weight": 1e-2 * LR, "noise_weight": 2 * LR * (1 + 1e-3)}
# chip_smoke.py's TRAIN_TOL for `small` at 4x518x518: gradients to 1e-3
# of their max (float32 sums over a million pixels in other orders).
SMALL_TOL = dict(TOL, grad=1e-3)
# Graphed steps held to as many eager ones.
STEPS = 4
# test_tensor_parallel_over_four_gpus's four ranks end within this.
RANKS_S = 600
# A graphed forward against its eager run, as a share of the output's max
# (tests/test_torch_graph_cache_cuda.py's MONO_TOL: the same kernels, but
# cuDNN's transposed convolution may sum with atomics).
MONO_TOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from depthestimation_torch.parallel.mesh import destroy_process_group, make_mesh

    m = make_mesh((1, 1, 1))
    yield m
    destroy_process_group()


@pytest.fixture(scope="module")
def tiny():
    net = MonoDepthModel.from_configs(ViTConfig(**TINY), DPTConfig(**TINY_DPT), seed=0,
                                      device="cpu").net
    with torch.no_grad():
        net.head.head_out.bias.fill_(2.0)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (4, 56, 56, 3)).astype(np.float32)
    targets = rng.uniform(0.5, 2.0, (4, 56, 56)).astype(np.float32)
    targets[0, :8] = 0.0
    with torch.no_grad():
        assert float(net(torch.from_numpy(images)).min()) > 0.1
    return net, images, targets


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def hold_step(local, ref, tol=TOL):
    """`local`'s gradients and weights after a step against `ref`'s (its
    parameters' .grad and values) at `tol`."""
    ref_params = dict(ref.named_parameters())
    for name, p in local.named_parameters():
        g = ref_params[name].grad.cpu()
        assert float((p.grad.cpu() - g).abs().max() / g.abs().max()) <= tol["grad"], name
        diff = (p.detach().cpu() - ref_params[name].detach().cpu()).abs()
        firm = g.abs() > tol["grad"] * g.abs().max()
        assert not firm.any() or float(diff[firm].max()) <= tol["weight"], name
        assert float(diff.max()) <= tol["noise_weight"], name


def test_train_step_card_matches_cpu(mesh, tiny, no_tf32):
    net, images, targets = tiny
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (56, 56), LR, seed=None)
    assert next(local.parameters()).is_cuda
    loss = float(train.make_train_step(local, opt, mesh, shardings)(images, targets))

    ref = copy.deepcopy(net)
    ref_opt = torch.optim.AdamW(ref.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    t = torch.from_numpy(targets)
    ref_loss = train.silog_loss(ref(torch.from_numpy(images)), t, t > 0)
    ref_loss.backward()
    ref_opt.step()

    ref_loss = float(ref_loss.detach())
    assert abs(loss - ref_loss) <= TOL["loss"] * abs(ref_loss)
    hold_step(local, ref)


def test_train_loss_falls_on_card(mesh, tiny):
    net, images, targets = tiny
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (56, 56), LR, seed=None)
    step = train.make_train_step(local, opt, mesh, shardings)
    x, t = (torch.from_numpy(a).cuda() for a in (images, targets))
    losses = [float(step(x, t)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_predict_sharded_card_matches_cpu(mesh, tiny, no_tf32):
    net, images, _ = tiny
    model = MonoDepthModel(net=copy.deepcopy(net).eval()).to_device("cuda")
    got = model.predict_sharded(images, mesh)
    with torch.no_grad():
        own = model.net(torch.from_numpy(images).cuda()).cpu().numpy()
        want = net.eval()(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, own)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _pairs(n, h=64, w=160, shift=7):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        base = rng.integers(0, 255, (h, w + shift)).astype(np.float32)
        base = np.round((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3.0)
        out.append((base[:, :w], base[:, shift:]))
    return out


def test_batch_pipeline_card_matches_single_pair(mesh):
    from depthestimation_torch.ops import cuda_sgm

    cfg = SGMConfig(num_disp=32, focal_length=500.0, baseline=0.1)
    pairs = _pairs(2)
    lb = torch.tensor(np.stack([p[0] for p in pairs])).cuda()
    rb = torch.tensor(np.stack([p[1] for p in pairs])).cuda()
    cuda_sgm.reset_launches()
    disp, depth = shard.batch_pipeline(mesh, cfg, fast_mode=True)(lb, rb)
    torch.cuda.synchronize()
    assert cuda_sgm.LAUNCHES["cost_volume"] == 2 and cuda_sgm.LAUNCHES["hscan"] == 4
    assert cuda_sgm.LAUNCHES["rowsweep"] == 2
    for i, (left, right) in enumerate(pairs):
        want = postprocess_and_depth(raw_disparity(lb[i], rb[i], cfg), cfg, fast_mode=True)
        assert torch.equal(disp[i], want[0]) and torch.equal(depth[i], want[1])
        cpu = postprocess_and_depth(raw_disparity(torch.from_numpy(left),
                                                  torch.from_numpy(right), cfg),
                                    cfg, fast_mode=True)
        assert torch.equal(disp[i].cpu(), cpu[0])


@pytest.mark.parametrize("mode", ["sgbm_3way", "hh"])
def test_disp_sharded_sgm_card_matches_kernels(mesh, mode):
    left, right = (torch.from_numpy(a).cuda() for a in _pairs(1)[0])
    cfg = SGMConfig(num_disp=32, sgbm_mode=mode, speckle_window_size=0)
    assert torch.equal(shard.disp_sharded_sgm(mesh, cfg)(left, right),
                       raw_disparity(left, right, cfg))


def test_tile_function_card_matches_cpu(mesh):
    left, right = _pairs(1)[0]
    cfg = SGMConfig(num_disp=32, sgbm_mode="hh4")

    def tiled(l, r):
        return torch.cat([shard.tile_disparity(shard.tile_with_halo(l, 4, i, 16),
                                               shard.tile_with_halo(r, 4, i, 16), cfg, 16)
                          for i in range(4)])

    card = tiled(torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda())
    assert torch.equal(card.cpu(), tiled(torch.from_numpy(left), torch.from_numpy(right)))
    # One tile on the one-rank mesh: the whole image with edge-replicated halos.
    l, r = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    assert torch.equal(shard.tile_sharded_disparity(mesh, cfg, halo=16)(l, r),
                       shard.tile_disparity(shard.tile_with_halo(l, 1, 0, 16),
                                            shard.tile_with_halo(r, 1, 0, 16), cfg, 16))


def test_graphed_train_step_matches_eager(mesh, tiny, no_tf32):
    """STEPS calls of make_train_step (the first runs the step and
    captures it, the others replay), each against a step.eager of a
    second train state into which the graphed one (weights, AdamW moments
    and step count) was copied just before: the loss, gradients and
    weights of every step at TOL. (Two runs that only start from the same
    weights drift apart over the steps: atomics reorder float sums, and
    Adam moves a weight by about lr whatever its gradient's size.) AdamW
    is capturable on the card, and its step count, on the card, reads
    STEPS after the replays: a count frozen at the capture would give
    every replay the first step's bias correction."""
    net, images, targets = tiny
    x, t = (torch.from_numpy(a).cuda() for a in (images, targets))
    (local, opt, shardings), (ref, ref_opt, _) = (
        train.make_sharded_train_state(net, mesh, (56, 56), LR, seed=None) for _ in range(2))
    assert opt.defaults["capturable"]
    step = train.make_train_step(local, opt, mesh, shardings)
    eager = train.make_train_step(ref, ref_opt, mesh, shardings).eager
    for k in range(STEPS):
        if k:
            with torch.no_grad():
                for pd, ps in zip(ref.parameters(), local.parameters()):
                    pd.copy_(ps)
                    for name, v in opt.state[ps].items():
                        ref_opt.state[pd][name].copy_(v)
        loss, want = float(step(x, t)), float(eager(x, t))
        assert abs(loss - want) <= TOL["loss"] * abs(want), (k, loss, want)
        hold_step(local, ref)
    (key, entry), = step.graph_cache.items()
    assert key == (((4, 56, 56, 3), torch.float32), ((4, 56, 56), torch.float32), False, False)
    assert isinstance(entry, CapturedCall) and entry.replays == STEPS - 1
    assert all(s["step"].is_cuda and float(s["step"]) == STEPS for s in opt.state.values())


def test_graphed_predict_matches_eager(mesh, tiny):
    """make_sharded_predict on the card: one graph per batch shape, the
    first call eager, replays within MONO_TOL of predict.eager; through
    MonoDepthModel.predict_sharded the sharded predict is kept under
    JAX's key, so a second call replays."""
    from depthestimation_torch.models.mono import MonoDepthModel

    net, images, _ = tiny
    model = MonoDepthModel(net=copy.deepcopy(net).eval()).to_device("cuda")
    predict = train.make_sharded_predict(model.net, mesh,
                                         train.param_shardings_for(model.net, mesh))
    batches = [torch.from_numpy(images[i:i + 2]).cuda() for i in (0, 2, 1)]
    outs = [predict(x) for x in batches]
    (entry,) = predict.graph_cache.values()
    assert isinstance(entry, CapturedCall) and entry.replays == 2
    for got, x in zip(outs, batches):
        want = predict.eager(x)
        assert float((got - want).abs().max() / want.abs().max()) <= MONO_TOL
    first = model.predict_sharded(images, mesh)
    second = model.predict_sharded(images[::-1].copy(), mesh)
    (sharded,) = model._graph_cache.values()
    assert sharded.graph_cache and next(iter(sharded.graph_cache.values())).replays == 1
    want = sharded.eager(images[::-1].copy()).cpu().numpy()
    assert np.abs(second - want).max() <= MONO_TOL * np.abs(want).max()
    assert np.abs(first[::-1] - second).max() <= MONO_TOL * np.abs(want).max()


def test_graphed_batch_pipeline_equals_eager(mesh):
    """batch_pipeline on the card: the first call with a batch shape
    captures, later calls replay, each equal bit for bit to run.eager and
    launching each frame's kernels once; another batch shape is another
    graph."""
    from depthestimation_torch.ops import cuda_sgm

    cfg = SGMConfig(num_disp=32, focal_length=500.0, baseline=0.1)
    pairs = _pairs(3)
    lb = torch.tensor(np.stack([p[0] for p in pairs])).cuda()
    rb = torch.tensor(np.stack([p[1] for p in pairs])).cuda()
    run = shard.batch_pipeline(mesh, cfg, fast_mode=True)
    for sl in (slice(0, 2), slice(1, 3), slice(0, 2), slice(2, 3)):
        cuda_sgm.reset_launches()
        disp, depth = run(lb[sl], rb[sl])
        torch.cuda.synchronize()
        n = disp.shape[0]
        assert cuda_sgm.LAUNCHES["cost_volume"] == n and cuda_sgm.LAUNCHES["hscan"] == 2 * n
        want = run.eager(lb[sl], rb[sl])
        assert torch.equal(disp, want[0]) and torch.equal(depth, want[1])
    assert sorted((k[1], e.replays) for k, e in run.graph_cache.items()) == [
        ((1, 64, 160), 0), ((2, 64, 160), 2)]


def test_train_step_capture_with_a_host_sync_raises(mesh, tiny):
    """A step that synchronises with the host cannot be captured: the
    first call runs it eagerly, then its capture raises, and nothing runs
    in place of the graph."""
    net, images, targets = tiny
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (56, 56), LR, seed=None)
    forward = local.forward
    local.forward = lambda x: forward(x) * float(x.sum() > 0)  # a host sync
    step = train.make_train_step(local, opt, mesh, shardings)
    with pytest.raises(RuntimeError, match="capture of train step as a CUDA graph failed"):
        step(images, targets)
    (entry,) = step.graph_cache.values()
    assert entry.graph is None and all(float(s["step"]) == 1 for s in opt.state.values())


def _small(seed=0):
    """`small` (seeded, on the CPU) with the head's output bias at 2, a
    4x518x518 batch (chip_smoke.py phase 3f's) and 2 images to predict."""
    net = MonoDepthModel.create("small", seed=seed, image_size=518, device="cpu").net
    with torch.no_grad():
        net.head.head_out.bias.fill_(2.0)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (4, 518, 518, 3)).astype(np.float32)
    targets = rng.uniform(0.5, 2.0, (4, 518, 518)).astype(np.float32)
    x = torch.rand(2, 518, 518, 3, generator=torch.Generator().manual_seed(1))
    return net, images, targets, x


def _tensor_parallel_rank(rank, world, store, work):
    """One rank of test_tensor_parallel_over_four_gpus (torch.multiprocessing):
    one step and predict_sharded at mesh (1, 1, 4), TF32 off; rank 0 saves
    the gathered gradients and weights, every rank its replica check and
    prediction. The group ends with the step's and the sharded predict's
    graphs (their NCCL work) still alive: mesh.destroy_process_group
    drops them first."""
    import torch.distributed as dist

    from depthestimation_torch.parallel.mesh import (destroy_process_group,
                                                     initialize_distributed, make_mesh)

    initialize_distributed(store, world, rank)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 1, world))
    net, images, targets, x = _small()
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (518, 518), LR, seed=None)
    step = train.make_train_step(local, opt, mesh, shardings)
    out = {"heads": local.backbone.block_0.attn.num_heads, "loss": float(step(images, targets))}
    grads = train.gather_params({n: p.grad for n, p in local.named_parameters()}, mesh,
                                shardings)
    weights = train.gather_params({n: p.detach() for n, p in local.named_parameters()},
                                  mesh, shardings)
    replicated = torch.cat([p.detach().reshape(-1) for n, p in local.named_parameters()
                            if shardings[n] is None])
    first = replicated.clone()
    dist.broadcast(first, src=0, group=mesh.get_group("model"))
    out["replicas_equal"] = torch.equal(first, replicated)
    model = MonoDepthModel(net=net.eval()).to_device(torch.device("cuda", rank))
    out["pred"] = model.predict_sharded(x, mesh)
    if rank == 0:
        out["grads"] = {n: g.cpu() for n, g in grads.items()}
        out["weights"] = {n: w.cpu() for n, w in weights.items()}
    step(images, targets)  # a replay
    (entry,) = step.graph_cache.values()
    out["step_replays"] = entry.replays
    torch.save(out, f"{work}/rank{rank}.pt")
    destroy_process_group()


def test_tensor_parallel_over_four_gpus(mesh, no_tf32, tmp_path):
    """`small`'s 6 heads over 4 'model' ranks (JAX's contiguous layout:
    qkv's output all-gathered, every head on every rank) against the
    one-rank step and the single forward."""
    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four GPUs")
    ctx = mp.spawn(_tensor_parallel_rank, args=(4, f"file://{tmp_path}/rendezvous",
                                                str(tmp_path)), nprocs=4, join=False)
    deadline = time.monotonic() + RANKS_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the four ranks did not end in {RANKS_S} s (a group that waits "
                        "for a live graph at its teardown?)")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]

    net, images, targets, x = _small()
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (518, 518), LR, seed=None)
    loss = float(train.make_train_step(local, opt, mesh, shardings)(images, targets))
    out = ranks[0]
    assert all(r["heads"] == 6 and r["replicas_equal"] and r["step_replays"] == 1
               for r in ranks)
    assert abs(out["loss"] - loss) <= SMALL_TOL["loss"] * abs(loss)
    for name, p in local.named_parameters():
        g = p.grad.cpu()
        err = float((out["grads"][name] - g).abs().max() / g.abs().max())
        assert err <= SMALL_TOL["grad"], (name, err)
        diff = (out["weights"][name] - p.detach().cpu()).abs()
        firm = g.abs() > SMALL_TOL["grad"] * g.abs().max()
        assert not firm.any() or float(diff[firm].max()) <= SMALL_TOL["weight"], name
        assert float(diff.max()) <= SMALL_TOL["noise_weight"], name
    del local, opt
    model = MonoDepthModel(net=net.eval()).to_device("cuda")
    with torch.no_grad():
        want = model.net(x.cuda()).cpu().numpy()
    for r in ranks:
        assert np.abs(r["pred"] - want).max() <= 1e-5 * np.abs(want).max()


def _as_flax(named):
    """The port's parameter names and tensors -> the JAX package's nested
    params (what convert.from_flax_params reads back)."""
    tree = {}
    for name, v in named.items():
        *path, leaf = name.split(".")
        a = v.detach().cpu().numpy()
        if leaf == "weight" and a.ndim in (2, 4):
            leaf, a = "kernel", (a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0))
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a
    return tree


def test_graphed_train_step_after_loading_state(mesh, tiny, no_tf32):
    """A captured step, then new optimizer state: an optax state through
    convert.load_optax_adam_state (copied into the tensors the graph
    holds, so the same graph replays on), torch's load_state_dict (new
    tensors: the step captures again) and a new lr (captured again). Each
    step against step.eager of a second state copied from the first just
    before, at TOL: a graph that kept the old moments, count or lr would
    move the weights by about lr elsewhere."""
    from depthestimation_torch.models import convert

    net, images, targets = tiny
    x, t = (torch.from_numpy(a).cuda() for a in (images, targets))
    (local, opt, shardings), (ref, ref_opt, _) = (
        train.make_sharded_train_state(net, mesh, (56, 56), LR, seed=None) for _ in range(2))
    step = train.make_train_step(local, opt, mesh, shardings)
    eager = train.make_train_step(ref, ref_opt, mesh, shardings).eager
    step(x, t), step(x, t)
    (key, first), = step.graph_cache.items()
    named = dict(local.named_parameters())
    mu = _as_flax({n: opt.state[p]["exp_avg"] * 2 for n, p in named.items()})
    nu = _as_flax({n: opt.state[p]["exp_avg_sq"] * 3 for n, p in named.items()})
    assert convert.from_flax_params(mu).keys() == named.keys()

    def held_step():
        with torch.no_grad():
            for pd, ps in zip(ref.parameters(), local.parameters()):
                pd.copy_(ps)
        ref_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
        loss, want = float(step(x, t)), float(eager(x, t))
        assert abs(loss - want) <= TOL["loss"] * abs(want), (loss, want)
        hold_step(local, ref)
        return step.graph_cache[key]

    convert.load_optax_adam_state(opt, local, 7, mu, nu)
    assert held_step() is first and first.replays == 2
    assert all(s["step"].is_cuda and float(s["step"]) == 8 for s in opt.state.values())
    sd = copy.deepcopy(opt.state_dict())
    for s in sd["state"].values():
        s["step"].fill_(20)
    opt.load_state_dict(sd)
    second = held_step()
    assert second is not first and first.graph is None and second.graph is not None
    assert all(float(s["step"]) == 21 for s in opt.state.values())
    for g in opt.param_groups:
        g["lr"] = LR / 4
    for g in ref_opt.param_groups:
        g["lr"] = LR / 4
    third = held_step()
    assert third is not second and second.graph is None
    held_step()
    assert step.graph_cache[key] is third and third.replays == 1


def test_release_collective_graphs(mesh, tiny):
    """graphs.release_collective_graphs drops the train step's and the
    sharded predict's graphs (what mesh.destroy_process_group does before
    it ends the group) and leaves a graph without collectives; the next
    call captures again."""
    from depthestimation_torch.graphs import release_collective_graphs

    net, images, targets = tiny
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (56, 56), LR, seed=None)
    step = train.make_train_step(local, opt, mesh, shardings)
    model = MonoDepthModel(net=copy.deepcopy(net).eval()).to_device("cuda")
    predict = train.make_sharded_predict(model.net, mesh,
                                         train.param_shardings_for(model.net, mesh))
    x = torch.from_numpy(images).cuda()
    for _ in range(2):
        step(images, targets), predict(x)
        with torch.inference_mode():
            model._forward(x)
    entries = [next(iter(f.graph_cache.values())) for f in (step, predict)]
    (own,) = model._graph_cache.values()
    assert all(e.graph is not None and e.replays == 1 for e in entries + [own])
    release_collective_graphs()
    assert all(e.graph is None for e in entries) and own.graph is not None
    step(images, targets), predict(x)
    assert all(e.graph is not None and e.replays == 1 for e in entries)
    assert float(next(iter(opt.state.values()))["step"]) == 3
