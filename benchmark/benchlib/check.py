"""The check that decides `correct`: a sample of the window's answers,
drawn from the seed, each compared with the plain reference run on the
same input after the window has closed.

Two numbers, each held to its cell's limit (limits/<cell>.json):
- mismatch_share: the largest share, over the sampled answers, of
  output elements (disparity and depth, or depth alone) that differ from
  the reference's (+inf equals +inf);
- depth_rel_gap: the largest |z - z_ref| / z_ref over the sampled depth
  maps, where both are finite.
A run with a failed item, or with nothing to compare, is not correct.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import spec
from .scenes import seed_sequence


@functools.cache
def _reference(name):
    return spec.load_module("reference", name)


def reference_outputs(config, names, left, right, device, dt=torch.float32):
    """The plain reference's outputs of a (left, right) uint8 pair, in
    the program's output types (`dt`: the type its stages after the
    matcher compute in)."""
    ref = _reference(config["reference"])
    left, right = (torch.as_tensor(a).to(device) for a in (left, right))
    disp, depth = ref.stereo_depth(left, right, config["sgm"], config["fast_mode"], dt)
    if names == ("disparity", "depth"):
        return disp.to(torch.float32), depth.to(torch.float32)
    return (depth.to(getattr(torch, config["stream_depth_dtype"])),)


class Sampler:
    """A uniform sample of k of the window's answers (reservoir sampling
    with a generator seeded from --seed)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed_sequence(seed, 3))
        self.items = []  # (window index, input key, outputs)

    def offer(self, index: int, key, outputs):
        if len(self.items) < self.k:
            self.items.append((index, key, outputs))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.k:
            self.items[j] = (index, key, outputs)


def compare(got, want, names):
    """(mismatch share, depth relative gap) of one answer: `got` host
    arrays, `want` reference tensors, both in the order of `names`."""
    total = wrong = 0
    gap = 0.0
    for name, g, w in zip(names, got, want):
        g = torch.as_tensor(np.asarray(g)).to(w.device)
        if g.shape != w.shape or g.dtype != w.dtype:
            return 1.0, 1.0
        total += w.numel()
        wrong += int((g != w).sum())
        if name == "depth":
            gf, wf = g.to(torch.float64), w.to(torch.float64)
            both = torch.isfinite(gf) & torch.isfinite(wf) & (wf > 0)
            if bool(both.any()):
                gap = max(gap, float((torch.abs(gf - wf)[both] / wf[both]).max()))
    return wrong / max(total, 1), gap


def judge(samples, reference, names, limits: dict, failed: int):
    """(correct, {number: (value, limit)}) of the sampled answers;
    reference(key) gives the reference outputs of an input key, run once
    per key."""
    values = {"mismatch_share": 0.0, "depth_rel_gap": 0.0}
    refs = {}
    for _, key, outputs in sorted(samples, key=lambda s: str(s[1])):
        if key not in refs:
            refs.clear()  # one input's reference on the device at a time
            refs[key] = reference(key)
        share, gap = compare(outputs, refs[key], names)
        values["mismatch_share"] = max(values["mismatch_share"], share)
        values["depth_rel_gap"] = max(values["depth_rel_gap"], gap)
    numbers = {k: (values[k], limits[k]) for k in limits}
    correct = bool(samples) and failed == 0 and all(v <= lim for v, lim in numbers.values())
    return correct, numbers
