"""Tile-parallel seam-accuracy sweep, on one device, tile by tile.

Splits a synthetic 1080p scene's rows into n tiles, runs each tile with
its halo rows through the matcher (parallel.shard.tile_with_halo +
tile_disparity: the CUDA kernels on the card), and measures per halo
width how far the tiled disparity is from the whole-image matcher:

- mismatch %: pixels whose disparity differs by > 1/16 px (one subpixel
  step) between tiled and whole, over the whole image;
- seam %: the same within +-8 rows of each internal seam;
- both again with the in-matcher speckle filter at 50 (speckle
  components are labelled per tile, the one stage where tiling is not the
  whole-image computation).

A rank of parallel.shard.tile_sharded_disparity computes the same tile
(its halo rows come from its neighbours), so this is that function's
accuracy without a process group.

    python -m depthestimation_torch.tools.halo_sweep [H W D] [--device cuda|cpu]

(8 tiles, hh4, halos 16, 32, 64 and 128 rows; sweep() takes others.)
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..config import SGMConfig
from ..io.synthetic import synthesize_stereo_pair
from ..parallel.shard import tile_disparity, tile_with_halo
from ..pipeline import _resolve_device, raw_disparity

HALOS = (16, 32, 64, 128)
SPECKLES = (0, 50)


def seam_metrics(tiled, whole, n_tiles: int, band: int = 8) -> Tuple[float, float]:
    """(% of pixels off by > 1/16 px overall, % within +-band rows of the
    internal seams)."""
    h = whole.shape[0]
    diff = np.abs(np.asarray(tiled) - np.asarray(whole)) > (1.0 / 16 + 1e-6)
    rows = []
    for i in range(1, n_tiles):
        s = i * (h // n_tiles)
        rows.extend(range(max(s - band, 0), min(s + band, h)))
    seam = diff[sorted(set(rows))]
    return 100.0 * diff.mean(), 100.0 * seam.mean()


def tiled_disparity(left: torch.Tensor, right: torch.Tensor, cfg: SGMConfig,
                    n_tiles: int, halo: int) -> torch.Tensor:
    """The tiled matcher's (H, W) disparity, one tile after another."""
    return torch.cat([tile_disparity(tile_with_halo(left, n_tiles, i, halo),
                                     tile_with_halo(right, n_tiles, i, halo), cfg, halo)
                      for i in range(n_tiles)])


def sweep(h: int = 1080, w: int = 1920, d: int = 128, n_tiles: int = 8,
          halos: Sequence[int] = HALOS, device="cuda", verbose: bool = True
          ) -> Dict[Tuple[int, int], Tuple[float, float]]:
    """{(speckle window, halo): (mismatch %, seam %)} of the hh4 matcher
    on the synthetic scene (h cut to a multiple of n_tiles, scene
    disparities up to min(d, 64)), without speckle filter and with it at
    50."""
    device = _resolve_device(device)
    h -= h % n_tiles
    left, right, _ = synthesize_stereo_pair(w, h, min(d, 64), seed=0)
    gl = torch.tensor(left[..., 0], dtype=torch.float32, device=device)
    gr = torch.tensor(right[..., 0], dtype=torch.float32, device=device)
    results = {}
    for speckle in SPECKLES:
        cfg = SGMConfig(num_disp=d, sgbm_mode="hh4", speckle_window_size=speckle)
        t0 = time.perf_counter()
        whole = raw_disparity(gl, gr, cfg).cpu().numpy()
        if verbose:
            print(f"[speckle={speckle}] whole image done in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        for halo in halos:
            t0 = time.perf_counter()
            tiled = tiled_disparity(gl, gr, cfg, n_tiles, halo).cpu().numpy()
            results[(speckle, halo)] = seam_metrics(tiled, whole, n_tiles)
            if verbose:
                tot, seam = results[(speckle, halo)]
                print(f"[speckle={speckle}] halo={halo:4d}: mismatch {tot:.4f}% "
                      f"total, {seam:.4f}% at seams "
                      f"({time.perf_counter() - t0:.2f} s)", flush=True)
    return results


def table(results) -> str:
    lines = ["| speckle | halo | mismatch total % | mismatch at seams % |",
             "|---|---|---|---|"]
    for (speckle, halo), (tot, seam) in sorted(results.items()):
        lines.append(f"| {speckle} | {halo} | {tot:.4f} | {seam:.4f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("shape", nargs="*", type=int, metavar="H W D",
                    help="image height, width and num_disp (default 1080 1920 128)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.shape and len(args.shape) != 3:
        ap.error("give H W D together")
    h, w, d = args.shape or (1080, 1920, 128)
    results = sweep(h, w, d, device=args.device)
    print()
    print(table(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
