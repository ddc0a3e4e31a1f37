"""Seeded stereo scenes: textured fronto-parallel planes painted far to
near over a textured background, seen by two rectified cameras, so that
occlusions are consistent and the disparities spread over the range.

Where the planes lie comes from the traffic's own layout seed, the same
in every run: the host's work on a depth map (the stream's statistics)
depends on how its depths are laid out, and a run's seed must not change
the work. The textures and the sensor noise come from --seed, made on
the device in a few large calls by `torch.Generator`s, then copied to
the host as the uint8 RGB arrays a user hands the facades. The same seed
on the same device gives the same frames.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed_sequence", "scene_views", "pair_pool", "drifting_frames"]


def seed_sequence(seed: int, *tags: int) -> np.random.SeedSequence:
    """The SeedSequence of --seed (any whole number, reduced mod 2**64)
    and optional tags."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *tags])


def _texture(h, w, gen, device):
    """(h, w) float32 in [0, 1]: noise summed over scales 1, 2, 4 and 8,
    lightly smoothed along rows (strong local contrast for the SAD)."""
    tex = torch.zeros((h, w), device=device)
    for s in (1, 2, 4, 8):
        low = torch.randn((h // s + 1, w // s + 1), generator=gen, device=device)
        tex += low.repeat_interleave(s, 0).repeat_interleave(s, 1)[:h, :w]
    tex = (tex + tex.roll(1, 1) + tex.roll(-1, 1)) / 3.0
    lo, hi = tex.min(), tex.max()
    return (tex - lo) / (hi - lo + 1e-9)


def _layout(rng: np.random.Generator, h, w, world_w, num_disp, scene: dict):
    """Background disparity and (disparity, x0, y0, width, height) of each
    plane, far to near: scene["planes"] gives each plane's disparity,
    width and height as shares of num_disp and of the frame's w and h;
    rng places them in the world's width."""
    bg = max(1, round(scene["background"] * num_disp))
    planes = []
    for fd, fw, fh in scene["planes"]:
        d = min(max(round(fd * num_disp), bg + 1), num_disp - 2)
        bw, bh = max(1, round(fw * w)), max(1, round(fh * h))
        x0 = int(rng.integers(0, max(1, world_w - bw)))
        y0 = int(rng.integers(0, max(1, h - bh)))
        planes.append((d, x0, y0, bw, bh))
    planes.sort()
    return bg, planes


def scene_views(ss: np.random.SeedSequence, layout: int, h, w, world_w, num_disp,
                scene: dict, device):
    """Left and right gray views (h, world_w) float32 in [0, 1] of one
    scene whose frames are w wide: the layout numbered `layout`, textures
    from ss. View v shows at pixel x the surface point X = x + v * d of
    the nearest surface there."""
    rng = np.random.default_rng([scene["layout_seed"], layout])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, dtype=np.uint64)[0]))
    bg, planes = _layout(rng, h, w, world_w, num_disp, scene)
    bg_tex = _texture(h, world_w + num_disp, gen, device)
    plane_tex = [_texture(bh, bw, gen, device) for _, _, _, bw, bh in planes]
    views = []
    for v in (0, 1):
        img = bg_tex[:, v * bg:v * bg + world_w].clone()
        for (d, x0, y0, bw, bh), tex in zip(planes, plane_tex):
            lo = x0 - v * d
            a, b = max(lo, 0), min(lo + bw, world_w)
            if a < b:
                img[y0:y0 + bh, a:b] = tex[:, a - lo:b - lo]
        views.append(img)
    return views


def _to_rgb(view, gen, scene: dict):
    """uint8 (h, w, 3): per-channel gain and offset, sensor noise of its
    own in each view."""
    gains = torch.tensor(scene["channel_gain"], device=view.device)
    noise = torch.randn(view.shape + (3,), generator=gen, device=view.device)
    rgb = view[..., None] * gains * 255.0 + scene["noise"] * noise
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def _host(t):
    return np.ascontiguousarray(t.cpu().numpy())


def _noise_gen(ss, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(2, dtype=np.uint64)[1]))
    return gen


def pair_pool(seed, n, h, w, num_disp, scene: dict, device):
    """n distinct (left, right) uint8 RGB pairs (h, w, 3), each a scene
    of its own layout."""
    pool = []
    for i, ss in enumerate(seed_sequence(seed, 1).spawn(n)):
        views = scene_views(ss, i, h, w, w, num_disp, scene, device)
        gen = _noise_gen(ss, device)
        pool.append(tuple(_host(_to_rgb(v, gen, scene)) for v in views))
    return pool


def drifting_frames(seed, n, h, w, num_disp, drift, scene: dict, device):
    """n (left, right) uint8 RGB frame pairs of one scene as the rig pans
    `drift` pixels a frame: frame i is columns [i * drift, i * drift + w)
    of both views."""
    ss = seed_sequence(seed, 2)
    views = scene_views(ss, 0, h, w, w + n * drift, num_disp, scene, device)
    gen = _noise_gen(ss, device)
    frames = []
    for i in range(n):
        frames.append(tuple(_host(_to_rgb(v[:, i * drift:i * drift + w], gen, scene))
                            for v in views))
    return frames
