"""Vision Transformer encoder, DINOv2-style (counterpart of
depthestimation_tpu/models/vit.py).

The backbone of Depth Anything V2 (the reference loads it through HF
transformers, MonocularDepthEstimator.py:1,32-37): patch embedding, cls
token, interpolated position embeddings, pre-norm blocks with LayerScale.
The math follows the JAX package's Flax module, whose choices differ from
torch's defaults in three places: LayerNorm eps 1e-6, the tanh form of
GELU, and a bicubic position-embedding resize with Keys' a = -0.5 and
antialias (jax.image.resize; F.interpolate uses a = -0.75). Submodules
carry the Flax module names, so a parameter path is the same in both
packages (models/convert.from_flax_params).

Attention is two explicit matmuls with the softmax in float32, one code
path on the CPU and on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import color

__all__ = ["ViTConfig", "ViT"]

# Flax nn.LayerNorm's epsilon (torch's default is 1e-5).
LN_EPS = 1e-6
# ImageNet normalisation (HF processor semantics), applied inside the net.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 518
    patch_size: int = 14
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    layerscale_init: float = 1.0
    out_layers: Tuple[int, ...] = (2, 5, 8, 11)

    @classmethod
    def small(cls, **kw):
        return cls(hidden_size=384, num_layers=12, num_heads=6,
                   out_layers=(2, 5, 8, 11), **kw)

    @classmethod
    def base(cls, **kw):
        return cls(hidden_size=768, num_layers=12, num_heads=12,
                   out_layers=(2, 5, 8, 11), **kw)

    @classmethod
    def large(cls, **kw):
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   out_layers=(4, 11, 17, 23), **kw)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x):
        b, t, d = x.shape
        head_dim = d // self.num_heads
        # (B, T, 3, H, Dh) -> three (B, H, T, Dh)
        q, k, v = self.qkv(x).reshape(b, t, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        attn = (q * head_dim**-0.5) @ k.transpose(-1, -2)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, t, d)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.hidden_size * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, cfg.hidden_size)

    def forward(self, x):
        # Flax nn.gelu is the tanh approximation.
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(d, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = Mlp(cfg)
        self.ls2 = LayerScale(d, cfg.layerscale_init)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class ViT(nn.Module):
    """DINOv2-style ViT returning the intermediate features named by
    cfg.out_layers (for the DPT decoder) plus the cls token per tap."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        grid0 = cfg.image_size // p
        self.patch_embed = nn.Conv2d(3, d, kernel_size=p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid0 * grid0 + 1, d))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", Block(cfg))
        # Shared final LayerNorm applied to every tap (Dinov2Backbone
        # apply_layernorm; HF weight 'backbone.layernorm').
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, images) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """images: (B, H, W, 3) float in [0, 1] (normalised here).

        Returns [(patch_tokens (B, h*w, D), cls (B, D)), ...], one per
        entry of cfg.out_layers (duplicates allowed)."""
        c = self.cfg
        x = (images.permute(0, 3, 1, 2) - self.mean) / self.std
        b, _, h, w = x.shape
        gh, gw = h // c.patch_size, w // c.patch_size
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, gh*gw, D)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)

        grid0 = c.image_size // c.patch_size
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (grid0, grid0):
            # Bicubic, as HF Dinov2 interpolate_pos_encoding, through
            # jax.image.resize's weights (antialiased when shrinking).
            grid = pos_patch.reshape(1, grid0, grid0, c.hidden_size)
            pos_patch = color.resize(grid, {1: gh, 2: gw}, "cubic").reshape(
                1, gh * gw, c.hidden_size)
        x = x + torch.cat([pos_cls, pos_patch], dim=1)

        by_layer = {}
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x)
            if i in c.out_layers:
                by_layer[i] = x
        taps = []
        for i in c.out_layers:
            normed = self.norm(by_layer[i])
            taps.append((normed[:, 1:, :], normed[:, 0, :]))
        return taps
