"""Weights from elsewhere -> the port's MonoDepthNet state dict
(counterpart of depthestimation_tpu/models/convert.py).

- An HF ``DepthAnythingForDepthEstimation`` snapshot (config.json +
  *.safetensors or pytorch_model*.bin). The HF tensors are torch layouts
  already, so only names change (and q, k, v become one qkv):
    backbone.embeddings.patch_embeddings.projection -> backbone.patch_embed
    backbone.embeddings.cls_token / position_embeddings -> backbone.cls_token / pos_embed
    backbone.encoder.layer.N.{attention,mlp,norms,layer_scale} -> backbone.block_N
    neck.reassemble_stage.layers.N.{projection,resize} -> head.project_N, head.resize_N
    neck.convs.N -> head.layer_rn_N
    neck.fusion_stage.layers.N -> head.fusion_{3-N} (HF lists them
        deepest first)
    head.{conv1,conv2,conv3} -> head.head_conv1, head_conv2, head_out
  .safetensors files are read without the safetensors package.
- The JAX package's Flax parameter tree (from_flax_params), whose module
  names the port's modules carry; its checkpoints' msgpack read without
  msgpack or flax (read_flax_msgpack); and its optax AdamW state carried
  into a torch optimizer (load_optax_adam_state).
"""

from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

__all__ = ["read_safetensors", "convert_state_dict", "load_hf_depth_anything",
           "from_flax_params", "read_flax_msgpack", "load_optax_adam_state"]

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a .safetensors file: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then
    the raw little-endian bytes the offsets point into."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def _load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    tensors = {}
    for fname in sorted(os.listdir(model_dir)):
        path = os.path.join(model_dir, fname)
        if fname.endswith(".safetensors"):
            tensors.update(read_safetensors(path))
        elif fname.endswith(".bin") and "pytorch_model" in fname:
            tensors.update(torch.load(path, map_location="cpu", weights_only=True))
    if not tensors:
        raise FileNotFoundError(f"No weight files found in {model_dir}")
    return tensors


def convert_state_dict(sd: Dict[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """HF DepthAnythingForDepthEstimation state dict -> MonoDepthNet
    state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(ours, theirs):
        out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        if f"{theirs}.bias" in sd:
            out[f"{ours}.bias"] = sd[f"{theirs}.bias"]

    put("backbone.patch_embed", "backbone.embeddings.patch_embeddings.projection")
    out["backbone.cls_token"] = sd["backbone.embeddings.cls_token"]
    out["backbone.pos_embed"] = sd["backbone.embeddings.position_embeddings"]
    put("backbone.norm", "backbone.layernorm")

    for i in range(num_layers):
        pre, ours = f"backbone.encoder.layer.{i}", f"backbone.block_{i}"
        qkv = [f"{pre}.attention.attention.{n}" for n in ("query", "key", "value")]
        out[f"{ours}.attn.qkv.weight"] = torch.cat([sd[f"{n}.weight"] for n in qkv], 0)
        out[f"{ours}.attn.qkv.bias"] = torch.cat([sd[f"{n}.bias"] for n in qkv], 0)
        put(f"{ours}.attn.proj", f"{pre}.attention.output.dense")
        put(f"{ours}.norm1", f"{pre}.norm1")
        put(f"{ours}.norm2", f"{pre}.norm2")
        put(f"{ours}.mlp.fc1", f"{pre}.mlp.fc1")
        put(f"{ours}.mlp.fc2", f"{pre}.mlp.fc2")
        out[f"{ours}.ls1.gamma"] = sd[f"{pre}.layer_scale1.lambda1"]
        out[f"{ours}.ls2.gamma"] = sd[f"{pre}.layer_scale2.lambda1"]

    for i in range(4):
        pre = f"neck.reassemble_stage.layers.{i}"
        put(f"head.project_{i}", f"{pre}.projection")
        if f"{pre}.resize.weight" in sd:
            # ConvTranspose2d (I, O, kh, kw) or Conv2d, as torch lays out both.
            put(f"head.resize_{i}", f"{pre}.resize")
        put(f"head.layer_rn_{i}", f"neck.convs.{i}")

    for i in range(4):
        pre, ours = f"neck.fusion_stage.layers.{i}", f"head.fusion_{3 - i}"
        # HF builds residual_layer1 in every stage; the deepest (i = 0) has
        # no skip and never uses it.
        rcus = (("residual_layer2", "rcu2"),) if i == 0 else (
            ("residual_layer1", "rcu1"), ("residual_layer2", "rcu2"))
        for theirs, rcu in rcus:
            put(f"{ours}.{rcu}.conv1", f"{pre}.{theirs}.convolution1")
            put(f"{ours}.{rcu}.conv2", f"{pre}.{theirs}.convolution2")
        put(f"{ours}.project", f"{pre}.projection")

    put("head.head_conv1", "head.conv1")
    put("head.head_conv2", "head.conv2")
    put("head.head_out", "head.conv3")
    return out


def hf_configs(hf_cfg: dict):
    """(ViTConfig, DPTConfig) of an HF DepthAnything config.json."""
    from .dpt import DPTConfig
    from .vit import ViTConfig

    bb = hf_cfg.get("backbone_config", {})
    out_indices = hf_cfg.get("backbone_out_indices")
    if out_indices is None:
        # HF out_indices are 1-based stage indices.
        out_indices = [i - 1 for i in bb.get("out_indices", [3, 6, 9, 12])]
    vit_cfg = ViTConfig(
        image_size=bb.get("image_size", 518),
        patch_size=bb.get("patch_size", 14),
        hidden_size=bb.get("hidden_size", 384),
        num_layers=bb.get("num_hidden_layers", 12),
        num_heads=bb.get("num_attention_heads", 6),
        out_layers=tuple(out_indices),
    )
    dpt_cfg = DPTConfig(
        features=hf_cfg.get("fusion_hidden_size", 64),
        reassemble_channels=tuple(hf_cfg.get("neck_hidden_sizes", (48, 96, 192, 384))),
        head_features=hf_cfg.get("head_hidden_size", 32),
    )
    return vit_cfg, dpt_cfg


def load_hf_depth_anything(model_dir: str, device="cuda"):
    """A MonoDepthModel with an HF snapshot's weights, on `device`
    (RuntimeError for "cuda" without a card)."""
    from ..pipeline import _resolve_device
    from .mono import MonoDepthModel, MonoDepthNet

    device = _resolve_device(device)

    with open(os.path.join(model_dir, "config.json")) as f:
        vit_cfg, dpt_cfg = hf_configs(json.load(f))
    net = MonoDepthNet(vit_cfg, dpt_cfg)
    sd = convert_state_dict(_load_state_dict(model_dir), vit_cfg.num_layers)
    net.load_state_dict({k: v.to(torch.float32) for k, v in sd.items()})
    return MonoDepthModel(net=net.eval()).to_device(device)


def from_flax_params(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX package's MonoDepthNet parameters (a nested dict of arrays,
    as nn.meta.unbox(variables)["params"] gives them) -> this package's
    state dict. Dense kernels (I, O) become (O, I); conv kernels
    (kh, kw, I, O) become (O, I, kh, kw) and transposed-conv kernels
    (kh, kw, O, I) become (I, O, kh, kw), the same permutation and no
    spatial flip (Flax's transpose_kernel=True is torch's
    ConvTranspose2d); LayerNorm's scale is its weight."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(from_flax_params(value, name + "."))
            continue
        a = np.asarray(value)
        if key == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            name = f"{prefix}weight"
        elif key == "scale":
            name = f"{prefix}weight"
        out[name] = torch.tensor(a, dtype=torch.float32)
    return out


# ---- the JAX package's checkpoints: flax.serialization msgpack -------------

# flax.serialization's msgpack ext codes (_MsgpackExtType).
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# Fixed-width msgpack types: first byte -> struct format (big-endian).
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


class _MsgpackReader:
    """The subset of msgpack that flax.serialization.msgpack_serialize
    writes: maps, arrays, strings, binaries, numbers, nil/bool and ext
    types, with flax's ndarray ext decoded to numpy."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def _take(self, n: int) -> memoryview:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return bytes(self._take(b & 0x1f)).decode()
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _FIXED:
            return self._unpack(_FIXED[b])
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self._take(self._unpack(">" + "BHI"[b - 0xc4])))
        if b in (0xd9, 0xda, 0xdb):
            return bytes(self._take(self._unpack(">" + "BHI"[b - 0xd9]))).decode()
        if b in (0xdc, 0xdd):
            return [self.read() for _ in range(self._unpack(">" + "HI"[b - 0xdc]))]
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">" + "HI"[b - 0xde]))
        if 0xd4 <= b <= 0xd8:
            return self._ext(1 << (b - 0xd4))
        if b in (0xc7, 0xc8, 0xc9):
            return self._ext(self._unpack(">" + "BHI"[b - 0xc7]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if out.get("__msgpack_chunked_array__"):
            # flax splits arrays above 1 GiB into flat chunks.
            shape = [out["shape"][str(i)] for i in range(len(out["shape"]))]
            chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not a flax array")
        shape, dtype, buffer = _MsgpackReader(payload).read()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_flax_msgpack(data: bytes):
    """The tree flax.serialization.msgpack_restore gives for `data` (nested
    dicts with numpy leaves), without msgpack or flax installed."""
    reader = _MsgpackReader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def load_optax_adam_state(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                          count, mu: Mapping, nu: Mapping) -> None:
    """Carry optax's ScaleByAdamState (count, mu, nu; the first state of
    optax.adamw's chain) into a torch Adam/AdamW optimizer over the whole
    of `net`'s parameters: step = count, exp_avg = mu, exp_avg_sq = nu,
    each moment laid out as from_flax_params lays out its parameter.
    Where a parameter already has that state, the values are copied into
    its tensors, so a captured train step (make_train_step) keeps replaying
    onto them."""
    moments = from_flax_params(mu), from_flax_params(nu)
    # A capturable optimizer (the train step's on the card) keeps its step
    # count on the parameters' device, as a CUDA graph's replay reads it.
    capturable = optimizer.defaults.get("capturable", False)
    for name, p in net.named_parameters():
        new = {
            "step": torch.tensor(float(np.asarray(count)),
                                 device=p.device if capturable else "cpu"),
            "exp_avg": moments[0][name].to(p.device),
            "exp_avg_sq": moments[1][name].to(p.device),
        }
        old = optimizer.state.get(p, {})
        if old.keys() == new.keys() and all(old[k].shape == v.shape and old[k].device == v.device
                                            for k, v in new.items()):
            with torch.no_grad():
                for k, v in new.items():
                    old[k].copy_(v)
        else:
            optimizer.state[p] = new
