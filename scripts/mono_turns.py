"""Time the monocular facade of a baseline tree against the checkout's, in
turns on one card: baseline, change, change, baseline.

    python3 scripts/mono_turns.py --baseline DIR [--out FILE]

DIR is the root of another copy of the repo (for example `git archive` of
an earlier commit unpacked under build/). Each turn is a fresh process that
imports that tree's depthestimation_torch, builds
MonocularDepthEstimator("small", device="cuda") (seeded random weights) and
feeds it a seeded 1080x1920 uint8 RGB image through its array path
(`_estimate_image`: preprocessing to 518x924, ViT + DPT, read-back,
inversion). After two warm-up images it reports:

- kernels, kernel_ms: the kernels of one predict_async (upload,
  preprocessing, forward) and the sum of their times, from a torch.profiler
  trace;
- host_enqueue_ms: median wall time of predict_async from an idle card
  (the host's cost to enqueue it);
- ms_per_image: median wall time of _estimate_image, which ends in the
  read-back.

Every turn's depth must equal the first turn's within 1e-5 of its largest
value (cuDNN may pick other algorithms in another process). One JSON line
goes to stdout (and to --out). Imports nothing of JAX or
depthestimation_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root: str, depth_out: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import depthestimation_torch as dt

    if not os.path.abspath(dt.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {dt.__file__}, not the tree at {root}")
    est = dt.MonocularDepthEstimator("small", device="cuda")
    img = np.random.default_rng(7).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    for _ in range(2):
        depth = est._estimate_image(img)
    np.save(depth_out, depth)
    torch.cuda.synchronize()
    enqueue, wall = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        est.model.predict_async(img)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    for _ in range(7):
        t0 = time.perf_counter()
        est._estimate_image(img)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.model.predict_async(img)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"kernels": len(kernels),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "host_enqueue_ms": float(np.median(enqueue)),
            "ms_per_image": float(np.median(wall))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", help="root of the baseline tree")
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--depth-out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.depth_out)))
        return 0
    import numpy as np

    if not args.baseline:
        parser.error("--baseline is required")
    roots = {"baseline": os.path.abspath(args.baseline), "change": REPO}
    turns, first = [], None
    for i, name in enumerate(("baseline", "change", "change", "baseline")):
        depth_out = os.path.join(REPO, "build", f"mono_turn_{i}.npy")
        os.makedirs(os.path.dirname(depth_out), exist_ok=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", roots[name],
             "--depth-out", depth_out],
            capture_output=True, text=True, timeout=600, cwd=roots[name])
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return 1
        numbers = json.loads(proc.stdout.strip().splitlines()[-1])
        depth = np.load(depth_out)
        if first is None:
            first = depth
        err = float(np.abs(depth - first).max() / np.abs(first).max())
        if depth.shape != (518, 924) or not err <= 1e-5:
            sys.stderr.write(f"turn {i} ({name}): depth {depth.shape}, rel err {err}\n")
            return 1
        turns.append(dict(turn=name, rel_err_vs_first=err, **numbers))
        print(f"turn {i} {name}: {turns[-1]}", file=sys.stderr)
    line = json.dumps({"mono_turns": turns})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
