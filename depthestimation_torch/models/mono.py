"""Monocular depth model: ViT encoder + DPT head (counterpart of
depthestimation_tpu/models/mono.py).

Capability parity with the reference's HF Depth-Anything-V2 pipeline
(MonocularDepthEstimator.py:27-76): load -> warm up -> per-image inference
returning relative depth. Weights come from the port's checkpoint, a
converted HF snapshot (models/convert.py) or a seeded random init with the
Flax initialisers (benchmarking, training from scratch).

Preprocessing resizes with PIL's BICUBIC arithmetic, written out in torch
so that it runs on the image's device: PIL is not needed, and the card's
result equals the CPU's bit for bit.
"""

from __future__ import annotations

import functools
import json
import math
import os
from dataclasses import asdict, dataclass, field

import numpy as np
import torch
from torch import nn

from ..graphs import cached, tf32_flags
from ..pipeline import _resolve_device
from .dpt import DPTConfig, DPTHead
from .vit import LayerScale, ViT, ViTConfig

__all__ = ["MonoDepthNet", "MonoDepthModel", "preprocess_image", "resize_bicubic_pil"]

_SIZE_PRESETS = {
    "small": (ViTConfig.small, DPTConfig(features=64,
                                         reassemble_channels=(48, 96, 192, 384))),
    "base": (ViTConfig.base, DPTConfig(features=128,
                                       reassemble_channels=(96, 192, 384, 768))),
    "large": (ViTConfig.large, DPTConfig(features=256,
                                         reassemble_channels=(256, 512, 1024, 1024))),
}

CONFIG_FILE = "depthestimation_torch_config.json"
STATE_FILE = "depthestimation_torch_state.pt"
# The JAX package's checkpoint (its MonoDepthModel.save): params as
# flax.serialization msgpack plus a config json of the same schema.
JAX_CONFIG_FILE = "depthestimation_tpu_config.json"
JAX_PARAMS_FILE = "depthestimation_tpu_params.msgpack"


class MonoDepthNet(nn.Module):
    """Encoder + head as one module: images (B, H, W, 3) in [0, 1] ->
    relative depth (B, H, W)."""

    def __init__(self, vit_cfg: ViTConfig, dpt_cfg: DPTConfig):
        super().__init__()
        self.vit_cfg, self.dpt_cfg = vit_cfg, dpt_cfg
        self.backbone = ViT(vit_cfg)
        self.head = DPTHead(dpt_cfg, vit_cfg.hidden_size)

    def forward(self, images):
        _, h, w, _ = images.shape
        taps = self.backbone(images)
        p = self.vit_cfg.patch_size
        return self.head(taps, (h // p, w // p), (h, w))


@torch.no_grad()
def init_flax(net: MonoDepthNet, generator: torch.Generator) -> MonoDepthNet:
    """Draw every parameter from the distribution its Flax initialiser
    uses (the numbers differ from JAX's: another generator): Xavier-uniform
    for dense layers and the patch conv, LeCun-normal (truncated at 2
    sigma) for the other convs, zero biases and cls token, normal(0.02)
    position embedding, LayerScale at its constant, LayerNorm at 1/0."""
    for name, m in net.named_modules():
        if isinstance(m, nn.Linear) or name == "backbone.patch_embed":
            nn.init.xavier_uniform_(m.weight, generator=generator)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # Flax's fan-in is the receptive field times dim 1 of the torch
            # weight for both: (O, I, kh, kw) and, for a transposed conv
            # (Flax kernel (kh, kw, O, I)), (I, O, kh, kw).
            w = m.weight
            std = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3])) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
        elif isinstance(m, LayerScale):
            nn.init.constant_(m.gamma, net.vit_cfg.layerscale_init)
        if getattr(m, "bias", None) is not None:
            nn.init.zeros_(m.bias)
    nn.init.zeros_(net.backbone.cls_token)
    nn.init.normal_(net.backbone.pos_embed, 0.0, 0.02, generator=generator)
    return net


# ---- PIL-free bicubic resize ----------------------------------------------

_PRECISION_BITS = 22  # PIL's fixed point for 8-bit images (32 - 8 - 2)


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic_filter (a = -0.5), in its order of operations."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=64)
def _pil_taps(n_in: int, n_out: int):
    """(index (n_out, k) int64, coefficient (n_out, k) float64) of PIL's
    precompute_coeffs + normalize_coeffs_8bpc for BICUBIC along one axis:
    the support widened by the scale when shrinking, the coefficients
    normalised by their sequential sum and rounded to 22-bit fixed point.
    The coefficients are integers; taps past a pixel's bound are 0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), n_in).astype(np.int64) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = _pil_bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                     * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    total = np.zeros(n_out)
    for t in range(ksize):  # PIL's order: a sequential sum
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total != 0.0, total, 1.0)[:, None], w)
    fixed = w * (1 << _PRECISION_BITS)
    coeff = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5))
    index = np.minimum(xmin[:, None] + taps[None, :], n_in - 1)
    return index, coeff


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; to the card through pinned memory
    without a wait (the pinned block is held until the copy is done)."""
    t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@functools.lru_cache(maxsize=64)
def _device_taps(n_in: int, n_out: int, device: torch.device):
    """_pil_taps uploaded to `device` once. Built outside inference mode,
    so that later autograd use of the cached tensors is allowed."""
    with torch.inference_mode(False):
        return tuple(_to_device(a, device) for a in _pil_taps(n_in, n_out))


def _pil_pass(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """One PIL resampling pass of float64 0..255 integers along `dim`:
    exact integer sums (< 2**53), then PIL's rounding and uint8 clip."""
    index, coeff = _device_taps(x.shape[dim], n_out, x.device)
    view = [1] * x.ndim
    view[dim] = n_out
    acc = sum(x.index_select(dim, index[:, t]) * coeff[:, t].view(view)
              for t in range(index.shape[1]))
    half = float(1 << (_PRECISION_BITS - 1))
    return torch.clamp(torch.floor((acc + half) / float(1 << _PRECISION_BITS)), 0, 255)


def resize_bicubic_pil(image: torch.Tensor, out_hw) -> torch.Tensor:
    """PIL Image.resize(BICUBIC) of a uint8 (H, W, C) tensor on its own
    device: horizontal pass, then vertical, each rounded and clipped to
    uint8 as PIL does; an axis whose size does not change is not
    resampled."""
    x = image.to(torch.float64)
    if out_hw[1] != x.shape[1]:
        x = _pil_pass(x, 1, out_hw[1])
    if out_hw[0] != x.shape[0]:
        x = _pil_pass(x, 0, out_hw[0])
    return x.to(torch.uint8)


def preprocess_image(image, target: int = 518, patch: int = 14,
                     device=None) -> torch.Tensor:
    """HF AutoImageProcessor-equivalent preprocessing of a uint8 RGB image
    (numpy or tensor, (H, W, 3)): scale to ~target on the short side, snap
    dims to patch multiples, PIL BICUBIC, [0, 1] float32 (H', W', 3) on
    `device` (default: the tensor's own, or the CPU for numpy).
    Normalisation lives inside the network."""
    if not isinstance(image, torch.Tensor):
        image = _to_device(image, torch.device(device or "cpu"))
    elif device is not None:
        image = image.to(device)
    h, w = image.shape[:2]
    scale = target / min(h, w)
    nh = max(int(round(h * scale / patch)) * patch, patch)
    nw = max(int(round(w * scale / patch)) * patch, patch)
    # Divide by a tensor on the image's device: for a host scalar divisor
    # CUDA multiplies by its reciprocal while the CPU (and numpy after
    # PIL) divide, which differs in the last bit.
    x = resize_bicubic_pil(image, (nh, nw)).to(torch.float32)
    return x / torch.full((), 255.0, device=x.device)


# ---- the model --------------------------------------------------------------


def _configs_from_meta(meta: dict):
    vit = ViTConfig(**{**meta["vit"], "out_layers": tuple(meta["vit"]["out_layers"])})
    dpt = DPTConfig(**{**meta["dpt"],
                       "reassemble_channels": tuple(meta["dpt"]["reassemble_channels"]),
                       "factors": tuple(meta["dpt"]["factors"])})
    return vit, dpt


@dataclass
class MonoDepthModel:
    """A loaded net on its device. predict() takes a uint8 RGB image and
    returns relative depth at the preprocessed resolution. create, load
    and from_configs put the net on the card unless given device="cpu";
    the constructor leaves `net` where it lies."""

    net: MonoDepthNet
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    # The net's forward per batch shape (JAX's _jit_cache, mono.py:164-176):
    # a CUDA graph on the card, the net itself on the CPU; and the sharded
    # predicts (predict_sharded, mono.py:200-218), each with its own graphs.
    _graph_cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_configs(cls, vit_cfg: ViTConfig, dpt_cfg: DPTConfig, seed: int = 0,
                     device="cuda") -> "MonoDepthModel":
        """A net with the Flax initialisers' distributions, drawn on the
        CPU from a torch.Generator seeded with `seed` (so the weights do
        not depend on the device), then moved to `device`."""
        device = _resolve_device(device)
        net = MonoDepthNet(vit_cfg, dpt_cfg)
        init_flax(net, torch.Generator().manual_seed(seed))
        return cls(net=net.eval()).to_device(device)

    @classmethod
    def create(cls, size: str = "small", seed: int = 0, image_size: int = 518,
               device="cuda") -> "MonoDepthModel":
        vit_fn, dpt_cfg = _SIZE_PRESETS[size]
        return cls.from_configs(vit_fn(image_size=image_size), dpt_cfg, seed, device)

    @classmethod
    def load(cls, model_path: str, device="cuda") -> "MonoDepthModel":
        """Load from a size preset name ('small'/'base'/'large': random
        init), a checkpoint directory written by save() or by the JAX
        package's save() (msgpack params, read without msgpack or flax),
        or an HF Depth-Anything-V2 snapshot directory (config.json +
        *.safetensors or pytorch_model*.bin, converted on the fly,
        models/convert.py), onto `device` (RuntimeError for "cuda"
        without a card)."""
        device = _resolve_device(device)
        if model_path in _SIZE_PRESETS:
            return cls.create(model_path, device=device)
        if os.path.isdir(model_path):
            if os.path.exists(os.path.join(model_path, STATE_FILE)):
                with open(os.path.join(model_path, CONFIG_FILE)) as f:
                    vit_cfg, dpt_cfg = _configs_from_meta(json.load(f))
                net = MonoDepthNet(vit_cfg, dpt_cfg)
                net.load_state_dict(torch.load(os.path.join(model_path, STATE_FILE),
                                               map_location="cpu", weights_only=True))
                return cls(net=net.eval()).to_device(device)
            if os.path.exists(os.path.join(model_path, JAX_PARAMS_FILE)):
                return cls._load_msgpack(model_path, device)
            if os.path.exists(os.path.join(model_path, "config.json")):
                from .convert import load_hf_depth_anything

                return load_hf_depth_anything(model_path, device)
        raise FileNotFoundError(f"No loadable model at {model_path}")

    @classmethod
    def _load_msgpack(cls, model_dir: str, device) -> "MonoDepthModel":
        """The JAX package's checkpoint directory: its config json (the full
        architecture, or a size preset and image size in the oldest
        checkpoints) and its Flax params, carried by from_flax_params."""
        from .convert import from_flax_params, read_flax_msgpack

        with open(os.path.join(model_dir, JAX_CONFIG_FILE)) as f:
            meta = json.load(f)
        if "vit" in meta:
            vit_cfg, dpt_cfg = _configs_from_meta(meta)
        else:
            vit_fn, dpt_cfg = _SIZE_PRESETS[meta["size"]]
            vit_cfg = vit_fn(image_size=meta["image_size"])
        net = MonoDepthNet(vit_cfg, dpt_cfg)
        with open(os.path.join(model_dir, JAX_PARAMS_FILE), "rb") as f:
            net.load_state_dict(from_flax_params(read_flax_msgpack(f.read())))
        return cls(net=net.eval()).to_device(device)

    def save(self, model_dir: str, size: str = "small", image_size: int = None):
        """Write the directory load() reads: the state dict plus a config
        json with the full ViT/DPT architecture, in the JAX checkpoint's
        schema (the size label is for humans; loading never trusts it)."""
        os.makedirs(model_dir, exist_ok=True)
        vit_cfg, dpt_cfg = self.net.vit_cfg, self.net.dpt_cfg
        meta = {"size": size,
                "image_size": image_size if image_size is not None else vit_cfg.image_size,
                "vit": asdict(vit_cfg), "dpt": asdict(dpt_cfg)}
        with open(os.path.join(model_dir, CONFIG_FILE), "w") as f:
            json.dump(meta, f)
        state = {k: v.detach().cpu() for k, v in self.net.state_dict().items()}
        torch.save(state, os.path.join(model_dir, STATE_FILE))

    def to_device(self, device) -> "MonoDepthModel":
        """Move the weights, and all later compute, to `device`."""
        self.device = torch.device(device)
        self.net.to(self.device)
        self._graph_cache.clear()
        return self

    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        """The net on a (B, H, W, 3) batch through the cache's entry for
        its shape and the TF32 flags (a graph keeps the kernels its
        capture chose)."""
        key = (tuple(batch.shape), *tf32_flags())
        return cached(self._graph_cache, key, self.net, "MonoDepthNet", self.device)(batch)

    @torch.inference_mode()
    def predict_async(self, image) -> torch.Tensor:
        """uint8 RGB image (H, W, 3) -> relative depth (H', W') float32 on
        the model's device, enqueued without waiting for the card. The
        preprocessing runs eagerly; on the card the net is one replay of
        its CUDA graph for the batch's shape, captured on first use
        (graphs.py). The weights are read in place, so load new ones
        into the net's tensors (load_state_dict), not by replacing them."""
        x = preprocess_image(image, device=self.device)
        return self._forward(x[None])[0]

    def predict(self, image) -> np.ndarray:
        """Single RGB uint8 image (H, W, 3) -> relative depth (H', W') at
        the preprocessed resolution (HF predicted_depth semantics)."""
        return self.predict_async(image).cpu().numpy()

    def predict_sharded(self, images, mesh, data_axis: str = "data") -> np.ndarray:
        """Batched sharded inference: preprocessed images (B, H, W, 3) float
        in [0, 1] (numpy or tensor, the same global batch on every rank)
        -> depth (B, H, W) numpy, the global result on every rank. The
        batch splits over `data_axis` and the weights over 'model', laid
        out as in the train step (models/train.py); with one 'model' rank
        the model's own net runs. Numerics are predict()'s net. The
        sharded predict is kept in the cache under JAX's key ("sharded",
        mesh, image shape; with data_axis), and on the card each batch
        shape is one CUDA graph replay (make_sharded_predict)."""
        from .train import _as_batch, make_sharded_predict, param_shardings_for

        images = _as_batch(images)
        key = ("sharded", mesh, tuple(images.shape[1:]), data_axis)
        predict = self._graph_cache.get(key)
        if predict is None:
            predict = make_sharded_predict(self.net, mesh, param_shardings_for(self.net, mesh),
                                           data_axis)
            self._graph_cache[key] = predict
        return predict(images).cpu().numpy()
