"""Convert a local HuggingFace Depth-Anything-V2 snapshot to the port's
checkpoint, offline.

    python -m depthestimation_torch.tools.convert_hf_checkpoint \\
        <hf_snapshot_dir> <out_dir> [--size small] [--verify] [--device cuda|cpu]

<hf_snapshot_dir> is a standard HF snapshot (config.json plus
model.safetensors or pytorch_model.bin, e.g. the result of
`huggingface-cli download depth-anything/Depth-Anything-V2-Small-hf`),
read without transformers or safetensors. <out_dir> receives the state
dict and the architecture json of MonoDepthModel.save, which
MonocularDepthEstimator(model_path=<out_dir>) loads.

--verify runs a forward pass through the converted model and through the
reloaded checkpoint on a seeded probe image and requires them bit-equal
(it catches serialization drift; the conversion itself is held to HF and
to the JAX package's converter by the tests).

Exit codes: 0 done, 1 the reloaded forward differs, 2 not an HF snapshot.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("snapshot", help="HF snapshot dir (config.json + weights)")
    ap.add_argument("out", help="output checkpoint dir")
    ap.add_argument("--size", default="small",
                    help="human-readable size label recorded in the config "
                         "(loading reads the full architecture, not this)")
    ap.add_argument("--verify", action="store_true",
                    help="round-trip a forward pass through the saved "
                         "checkpoint and require bit-identical output")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..models.convert import load_hf_depth_anything
    from ..models.mono import STATE_FILE, MonoDepthModel

    if not os.path.exists(os.path.join(args.snapshot, "config.json")):
        print(f"error: {args.snapshot} has no config.json: not an HF "
              "snapshot directory", file=sys.stderr)
        return 2

    print(f"Converting {args.snapshot} ...")
    model = load_hf_depth_anything(args.snapshot, device=args.device)
    n_params = sum(p.numel() for p in model.net.parameters())
    model.save(args.out, size=args.size)
    ckpt = os.path.join(args.out, STATE_FILE)
    print(f"Wrote {ckpt} ({os.path.getsize(ckpt) / 2**20:.1f} MB, "
          f"{n_params / 1e6:.1f}M params)")

    if args.verify:
        side = model.net.vit_cfg.patch_size * 4
        rng = np.random.default_rng(0)
        img = torch.from_numpy(rng.uniform(0, 1, (1, side, side, 3)).astype(np.float32))
        reloaded = MonoDepthModel.load(args.out, device=args.device)
        with torch.inference_mode():
            want = model.net(img.to(model.device)).cpu()
            got = reloaded.net(img.to(reloaded.device)).cpu()
        if not torch.equal(want, got):
            print("error: reloaded checkpoint output differs from the "
                  "converted model", file=sys.stderr)
            return 1
        print(f"Verified: reloaded forward is bit-identical "
              f"({side}x{side} probe).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
