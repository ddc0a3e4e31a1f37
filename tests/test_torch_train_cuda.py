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
  max of the single forward.

Every test here needs an NVIDIA GPU and skips without one. This file
imports nothing of JAX; on a machine with a card and no JAX, run it
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_train_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from depthestimation_torch.config import SGMConfig
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


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from depthestimation_torch.parallel.mesh import make_mesh

    m = make_mesh((1, 1, 1))
    yield m
    torch.distributed.destroy_process_group()


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
    ref_params = dict(ref.named_parameters())
    for name, p in local.named_parameters():
        g = ref_params[name].grad
        assert float((p.grad.cpu() - g).abs().max() / g.abs().max()) <= TOL["grad"], name
        diff = (p.detach().cpu() - ref_params[name].detach()).abs()
        firm = g.abs() > TOL["grad"] * g.abs().max()
        assert not firm.any() or float(diff[firm].max()) <= TOL["weight"], name
        assert float(diff.max()) <= TOL["noise_weight"], name


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
    prediction."""
    import torch.distributed as dist

    from depthestimation_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(store, world, rank)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 1, world))
    net, images, targets, x = _small()
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (518, 518), LR, seed=None)
    out = {"heads": local.backbone.block_0.attn.num_heads,
           "loss": float(train.make_train_step(local, opt, mesh, shardings)(images, targets))}
    grads = train.gather_params({n: p.grad for n, p in local.named_parameters()}, mesh,
                                shardings)
    weights = train.gather_params({n: p.detach() for n, p in local.named_parameters()},
                                  mesh, shardings)
    replicated = torch.cat([p.detach().reshape(-1) for n, p in local.named_parameters()
                            if shardings[n] is None])
    first = replicated.clone()
    dist.broadcast(first, src=0, group=mesh.get_group("model"))
    out["replicas_equal"] = torch.equal(first, replicated)
    del local, opt
    model = MonoDepthModel(net=net.eval()).to_device(torch.device("cuda", rank))
    out["pred"] = model.predict_sharded(x, mesh)
    if rank == 0:
        out["grads"] = {n: g.cpu() for n, g in grads.items()}
        out["weights"] = {n: w.cpu() for n, w in weights.items()}
    torch.save(out, f"{work}/rank{rank}.pt")
    dist.destroy_process_group()


def test_tensor_parallel_over_four_gpus(mesh, no_tf32, tmp_path):
    """`small`'s 6 heads over 4 'model' ranks (JAX's contiguous layout:
    qkv's output all-gathered, every head on every rank) against the
    one-rank step and the single forward."""
    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four GPUs")
    mp.spawn(_tensor_parallel_rank, args=(4, f"file://{tmp_path}/rendezvous", str(tmp_path)),
             nprocs=4, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]

    net, images, targets, x = _small()
    local, opt, shardings = train.make_sharded_train_state(net, mesh, (518, 518), LR, seed=None)
    loss = float(train.make_train_step(local, opt, mesh, shardings)(images, targets))
    out = ranks[0]
    assert all(r["heads"] == 6 and r["replicas_equal"] for r in ranks)
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
