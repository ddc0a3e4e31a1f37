"""Sharded training step for the monocular depth net (counterpart of
depthestimation_tpu/models/train.py).

Data parallelism over the batch ('data' axis) and tensor parallelism over
the ViT's heads and MLP hidden units ('model' axis), on a DeviceMesh
(parallel/mesh.py). JAX lays the parameters out with flax's logical axes
and lets GSPMD insert the collectives; here the layout is written out:

- Tensor parallelism holds explicit slices, Megatron style. A rank keeps
  the q, k and v columns of its own heads of `qkv` and its block of
  `fc1`'s output units (column parallel; the input's gradient is summed
  over 'model'), and the matching input rows of `proj` and `fc2` (row
  parallel: the partial products are summed over 'model', then the bias,
  held whole, is added once). Explicit slices rather than DTensor's
  parallelize_module, because `qkv` is not split in contiguous blocks
  (its output is q | k | v, each over all heads) and because the same
  code then runs over gloo on the CPU, where the tests hold it to JAX.
  Every other parameter is replicated.
- The loss is JAX's global SiLog: n, sum(d) and sum(d^2) over every pixel
  of every data shard (all-reduced over 'data'), so every rank holds the
  global loss. Its backward is the identity on each rank's own sums, so a
  rank's gradients are its shard's share of the global gradient, and the
  gradients are summed (not averaged) over 'data'.
- AdamW with optax.adamw's defaults, passed explicitly: b1 0.9, b2 0.999,
  eps 1e-8, weight decay 1e-4 on every parameter (biases, LayerNorm and
  LayerScale included), one param group.

Loss: scale-invariant log loss (SiLog) with a validity mask.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import axis_info
from .mono import MonoDepthNet, init_flax

__all__ = ["LOGICAL_RULES", "make_sharded_train_state", "make_train_step",
           "make_sharded_predict", "param_shardings_for", "shard_net", "gather_params",
           "silog_loss"]

# Logical-axis -> mesh-axis rules, as in JAX. 'embed' stays replicated
# (activations shard over the batch); 'mlp' and 'heads' shard over the
# tensor-parallel 'model' axis.
LOGICAL_RULES = (
    ("embed", None),
    ("mlp", "model"),
    ("heads", "model"),
)

# Logical axis of the split dimension of each tensor-parallel linear, and
# that dimension in torch's (out, in) weight: qkv and fc1 by output
# columns, proj and fc2 by input rows (JAX vit.py: ("embed", "heads"),
# ("heads", "embed"), ("embed", "mlp"), ("mlp", "embed")).
_PARALLEL_LINEARS = {"attn.qkv": ("heads", 0), "attn.proj": ("heads", 1),
                     "mlp.fc1": ("mlp", 0), "mlp.fc2": ("mlp", 1)}


# ---- collectives with the gradients tensor parallelism needs ----------------


class _SumOverGroup(torch.autograd.Function):
    """Forward: all-reduce sum over `group`. Backward: identity, for a
    result that every rank of the group then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: identity. Backward: all-reduce sum over `group`, for an
    input that every rank feeds into its own slice of a layer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ColumnParallelLinear(nn.Linear):
    """A rank's output columns of a linear layer; the input is replicated
    over the group."""

    def __init__(self, weight, bias, group):
        super().__init__(weight.shape[1], weight.shape[0], device=weight.device)
        self.group = group
        with torch.no_grad():
            self.weight.copy_(weight)
            self.bias.copy_(bias)

    def forward(self, x):
        return F.linear(_CopyToGroup.apply(x, self.group), self.weight, self.bias)


class _RowParallelLinear(nn.Linear):
    """A rank's input rows of a linear layer: partial products summed over
    the group, then the whole bias added once."""

    def __init__(self, weight, bias, group):
        super().__init__(weight.shape[1], weight.shape[0], device=weight.device)
        self.group = group
        with torch.no_grad():
            self.weight.copy_(weight)
            self.bias.copy_(bias)

    def forward(self, x):
        return _SumOverGroup.apply(F.linear(x, self.weight), self.group) + self.bias


# ---- layout -------------------------------------------------------------------


def silog_loss(pred, target, valid, lam: float = 0.5, eps: float = 1e-6,
               group=None):
    """Scale-invariant log loss over valid pixels. With `group`, n, sum(d)
    and sum(d^2) are summed over its ranks first: the loss of the global
    batch, on every rank (see the module docstring for its gradient)."""
    d = torch.log(pred + eps) - torch.log(target + eps)
    d = torch.where(valid, d, torch.zeros((), dtype=d.dtype, device=d.device))
    sums = torch.stack([(d * d).sum(), d.sum()])
    n = valid.sum()
    if group is not None:
        sums = _SumOverGroup.apply(sums, group)
        dist.all_reduce(n, group=group)
    n = torch.clamp(n, min=1)
    mse, mean = sums[0] / n, sums[1] / n
    return mse - lam * mean * mean


def _blocks(net: MonoDepthNet):
    return [getattr(net.backbone, f"block_{i}") for i in range(net.vit_cfg.num_layers)]


def param_shardings_for(net: MonoDepthNet, mesh, image_hw=None) -> Dict[str, Optional[Tuple[str, int]]]:
    """{parameter name: (mesh axis, split dim) or None (replicated)} for
    every parameter of the full net, from LOGICAL_RULES. The split
    weights' biases split with them where the output is split (qkv, fc1)
    and stay whole where it is not (proj, fc2). `qkv`'s dim-0 split is by
    heads: a rank holds the q, k and v rows of its own heads. image_hw is
    accepted for the JAX signature; a torch module knows its shapes.

    Raises ValueError unless the mesh's 'model' size divides num_heads
    and the MLP's hidden width (JAX accepts any divisor of 3 * hidden)."""
    rules = dict(LOGICAL_RULES)
    model = mesh.size(mesh.mesh_dim_names.index("model")) if "model" in mesh.mesh_dim_names else 1
    cfg = net.vit_cfg
    mlp_hidden = int(cfg.hidden_size * cfg.mlp_ratio)
    if cfg.num_heads % model or mlp_hidden % model:
        raise ValueError(f"the 'model' axis ({model}) must divide num_heads "
                         f"({cfg.num_heads}) and the MLP width ({mlp_hidden})")
    out = {}
    for name, _ in net.named_parameters():
        module, _, leaf = name.rpartition(".")
        kind = next((k for k in _PARALLEL_LINEARS if module.endswith(k)), None)
        spec = None
        if kind is not None:
            logical, dim = _PARALLEL_LINEARS[kind]
            axis = rules[logical]
            if axis is not None and (leaf == "weight" or dim == 0):
                spec = (axis, dim)
        out[name] = spec
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows_of_rank(full: int, rank: int, size: int, qkv: bool):
    """Indices along the split dim held by `rank`: a contiguous block, or
    for qkv the block of this rank's heads inside each of q, k and v."""
    if not qkv:
        per = full // size
        return torch.arange(rank * per, (rank + 1) * per)
    d = full // 3
    per = d // size
    return torch.cat([torch.arange(j * d + rank * per, j * d + (rank + 1) * per)
                      for j in range(3)])


def shard_net(net: MonoDepthNet, mesh, shardings) -> MonoDepthNet:
    """This rank's net on the mesh's device: a copy of `net` whose
    tensor-parallel linears hold the rank's slices (by `shardings`), or
    `net` itself when the 'model' axis has one rank and the net is on that
    device already. A net that already holds slices is returned as is."""
    device = _mesh_device(mesh)
    if any(isinstance(m, (_ColumnParallelLinear, _RowParallelLinear)) for m in net.modules()):
        return net
    axes = {spec[0] for spec in shardings.values() if spec is not None}
    group, rank, size = axis_info(mesh, axes.pop()) if axes else (None, 0, 1)
    on_device = next(net.parameters()).device == device
    if size == 1:
        return net if on_device else copy.deepcopy(net).to(device)
    local = copy.deepcopy(net).to(device)
    for block in _blocks(local):
        block.attn.num_heads //= size
        for kind, (_, dim) in _PARALLEL_LINEARS.items():
            owner_name, attr = kind.split(".")
            owner = getattr(block, owner_name)
            full = getattr(owner, attr)
            idx = _rows_of_rank(full.weight.shape[dim], rank, size,
                                attr == "qkv").to(device)
            weight = full.weight.detach().index_select(dim, idx)
            if dim == 0:
                layer = _ColumnParallelLinear(weight, full.bias.detach()[idx], group)
            else:
                layer = _RowParallelLinear(weight, full.bias.detach(), group)
            setattr(owner, attr, layer)
    return local


def gather_params(tensors: Dict[str, torch.Tensor], mesh, shardings) -> Dict[str, torch.Tensor]:
    """The full tensors of a sharded net's {name: this rank's tensor}
    (its parameters, their gradients or optimizer moments), gathered over
    their mesh axis, on every rank: what shard_net split, put back
    together (qkv head by head inside each of q, k and v)."""
    out = {}
    for name, t in tensors.items():
        spec = shardings[name]
        if spec is None:
            out[name] = t.clone()
            continue
        axis, dim = spec
        group, _, size = axis_info(mesh, axis)
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        if name.rpartition(".")[0].endswith("attn.qkv"):
            # each part is [q_r; k_r; v_r]: regroup as [q; k; v].
            parts = [part.chunk(3, dim)[j] for j in range(3) for part in parts]
        out[name] = torch.cat(parts, dim)
    return out


def make_sharded_train_state(net: MonoDepthNet, mesh, image_hw,
                             learning_rate: float = 1e-4, seed: Optional[int] = 0):
    """This rank's train state: (net, optimizer, shardings).

    net is a copy of `net` laid out by param_shardings_for on the mesh's
    device, its weights drawn as MonoDepthModel.create draws them from
    `seed` (JAX inits from a seed too), or kept as `net` holds them for
    seed=None (a loaded checkpoint, JAX's weights). The optimizer is
    AdamW with optax.adamw's defaults over its parameters."""
    shardings = param_shardings_for(net, mesh, image_hw)
    net = copy.deepcopy(net)
    if seed is not None:  # drawn on the CPU, so the weights do not depend on the device
        init_flax(net.cpu(), torch.Generator().manual_seed(seed))
    local = shard_net(net, mesh, shardings)
    optimizer = torch.optim.AdamW(local.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
    return local, optimizer, shardings


def _data_shard(x, index: int, size: int, device) -> torch.Tensor:
    """Rows [index * B/size, (index + 1) * B/size) of a global batch,
    as float32 on `device`."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    if x.shape[0] % size:
        raise ValueError(f"batch of {x.shape[0]} does not split over {size} data ranks")
    per = x.shape[0] // size
    return x[index * per:(index + 1) * per].to(device=device, dtype=torch.float32)


def _through_flat(tensors, collective) -> None:
    """Run `collective` on the tensors packed into one flat tensor, and
    copy its result back into them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_train_step(net: MonoDepthNet, optimizer, mesh, shardings):
    """The train step of make_sharded_train_state's (net, optimizer).

    step(images (B, H, W, 3), targets (B, H, W)) -> loss. Every rank
    passes the same global batch (numpy or tensor) and takes its 'data'
    shard; the step updates the rank's parameters in place and returns
    the global batch's loss, a 0-dim tensor on the mesh's device, without
    waiting for the card. Pixels with target > 0 are valid.

    With more than one 'model' rank, the replicated parameters' gradients
    are the first model rank's on every rank of its group: each rank
    computes them whole, equal only up to the order of float sums (the
    card's backward kernels add with atomics), and Adam's first steps
    move a weight by about lr whatever its gradient's size, so a sign
    that differs between two ranks would set their copies lr apart."""
    group, index, size = axis_info(mesh, "data")
    model_group, _, model_size = (axis_info(mesh, "model") if "model" in mesh.mesh_dim_names
                                  else (None, 0, 1))
    device = _mesh_device(mesh)
    params = list(net.parameters())
    replicated = [p for name, p in net.named_parameters() if shardings[name] is None]

    def step(images, targets):
        images = _data_shard(images, index, size, device)
        targets = _data_shard(targets, index, size, device)
        optimizer.zero_grad(set_to_none=False)
        loss = silog_loss(net(images), targets, targets > 0, group=group)
        loss.backward()
        for p in params:
            # optax decays every leaf, one that got no gradient too.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if size > 1:
            _through_flat([p.grad for p in params],
                          lambda flat: dist.all_reduce(flat, group=group))
        if model_size > 1 and replicated:
            src = dist.get_global_rank(model_group, 0)
            _through_flat([p.grad for p in replicated],
                          lambda flat: dist.broadcast(flat, src=src, group=model_group))
        optimizer.step()
        return loss.detach()

    return step


def make_sharded_predict(net: MonoDepthNet, mesh, param_shardings, data_axis: str = "data"):
    """Sharded inference: batch over `data_axis`, parameters laid out over
    'model' as in the train step (a full net is sliced by shard_net once,
    here). Returns predict(images (B, H, W, 3)) -> depth (B, H, W): every
    rank passes the same global batch (numpy or tensor) and gets the
    global result, gathered over `data_axis`, on the mesh's device."""
    local = shard_net(net, mesh, param_shardings)
    group, index, size = axis_info(mesh, data_axis)
    device = _mesh_device(mesh)

    def predict(images):
        x = _data_shard(images, index, size, device)
        with torch.no_grad():
            out = local(x)
        if size == 1:
            return out
        parts = [torch.empty_like(out) for _ in range(size)]
        dist.all_gather(parts, out.contiguous(), group=group)
        return torch.cat(parts)

    return predict
