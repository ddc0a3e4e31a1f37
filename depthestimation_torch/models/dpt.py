"""DPT (Dense Prediction Transformer) depth head (counterpart of
depthestimation_tpu/models/dpt.py).

The decoder half of Depth Anything V2 (the reference gets it from HF
transformers, MonocularDepthEstimator.py:33,68-70): reassemble 4 ViT taps
into multi-scale feature maps, fuse coarse-to-fine with residual conv
units, and regress relative depth at input resolution. Feature maps are
NCHW; submodules carry the Flax module names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import color

__all__ = ["DPTConfig", "DPTHead"]


@dataclass(frozen=True)
class DPTConfig:
    features: int = 64  # fusion width (DAV2: 64/128/256 for S/B/L)
    reassemble_channels: Tuple[int, ...] = (48, 96, 192, 384)
    # Per-tap spatial factor relative to the patch grid: upsample x4, x2,
    # keep, downsample /2 (standard DPT reassembly).
    factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    head_features: int = 32


def _conv3x3(cin, cout, bias=True):
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv3x3(features, features)
        self.conv2 = _conv3x3(features, features)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def _resize_align_corners(x, out_hw):
    """Bilinear resize with align_corners=True semantics on (B, C, H, W),
    in the JAX package's gather-and-blend form (dpt.py:47-72)."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x

    def coords(n_out, n_in):
        if n_out <= 1 or n_in <= 1:
            return torch.zeros(n_out, dtype=torch.float32, device=x.device)
        return torch.arange(n_out, dtype=torch.float32, device=x.device) * (
            (n_in - 1) / (n_out - 1))

    ys, xs = coords(oh, h), coords(ow, w)
    y0 = torch.floor(ys).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fy = (ys - y0)[:, None]
    x0 = torch.floor(xs).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fx = xs - x0

    rows = x[:, :, y0] * (1 - fy) + x[:, :, y1] * fy  # (B, C, oh, W)
    return rows[..., x0] * (1 - fx) + rows[..., x1] * fx


class FeatureFusion(nn.Module):
    """HF DepthAnythingFeatureFusionLayer semantics: the skip resized to x
    if needed, pre-act residual units, then an align_corners=True upsample
    to out_hw (x2 when None), then a 1x1 projection."""

    def __init__(self, features: int, has_skip: bool):
        super().__init__()
        if has_skip:
            self.rcu1 = ResidualConvUnit(features)
        self.rcu2 = ResidualConvUnit(features)
        self.project = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            if x.shape[-2:] != skip.shape[-2:]:
                # jax.image.resize 'bilinear', antialiased by default.
                skip = color.resize(skip, {2: x.shape[2], 3: x.shape[3]}, "linear")
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if out_hw is None:
            out_hw = (x.shape[2] * 2, x.shape[3] * 2)
        return self.project(_resize_align_corners(x, out_hw))


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTConfig, hidden_size: int):
        super().__init__()
        self.cfg = cfg
        for i, ch in enumerate(cfg.reassemble_channels):
            self.add_module(f"project_{i}", nn.Conv2d(hidden_size, ch, 1))
            # Learned resampling, as DPT/DepthAnything reassembly:
            # ConvTranspose x4 / x2, identity, strided 3x3 conv for /2
            # (symmetric padding 1, as torch pads).
            f = cfg.factors[i]
            if f in (4.0, 2.0):
                k = int(f)
                self.add_module(f"resize_{i}", nn.ConvTranspose2d(ch, ch, k, stride=k))
            elif f == 0.5:
                self.add_module(f"resize_{i}", nn.Conv2d(ch, ch, 3, stride=2, padding=1))
            self.add_module(f"layer_rn_{i}", _conv3x3(ch, cfg.features, bias=False))
        for i in range(4):
            self.add_module(f"fusion_{i}", FeatureFusion(cfg.features, has_skip=i < 3))
        mid = max(cfg.features // 2, 1)
        self.head_conv1 = _conv3x3(cfg.features, mid)
        self.head_conv2 = _conv3x3(mid, cfg.head_features)
        self.head_out = nn.Conv2d(cfg.head_features, 1, 1)

    def forward(self, taps: Sequence, grid_hw: Tuple[int, int],
                out_hw: Tuple[int, int]):
        """taps: 4x (patch_tokens (B, T, D), cls (B, D)); returns relative
        depth (B, out_h, out_w) >= 0, float32."""
        gh, gw = grid_hw
        feats = []
        for i, (tokens, _cls) in enumerate(taps):
            b, _, d = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, d, gh, gw)
            x = getattr(self, f"project_{i}")(x)
            if hasattr(self, f"resize_{i}"):
                x = getattr(self, f"resize_{i}")(x)
            feats.append(getattr(self, f"layer_rn_{i}")(x))

        # Coarse-to-fine fusion, deepest tap first; each stage upsamples to
        # the next finer feature's resolution, the last one x2.
        x = self.fusion_3(feats[3], out_hw=feats[2].shape[-2:])
        x = self.fusion_2(x, feats[2], out_hw=feats[1].shape[-2:])
        x = self.fusion_1(x, feats[1], out_hw=feats[0].shape[-2:])
        x = self.fusion_0(x, feats[0])

        # HF DepthAnything head: conv1 -> features//2, upsample to input
        # resolution, conv2 -> head_features, relu, 1x1 -> depth.
        x = _resize_align_corners(self.head_conv1(x), out_hw)
        x = self.head_out(F.relu(self.head_conv2(x)))
        return F.relu(x[:, 0]).float()
