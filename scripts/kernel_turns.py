"""Time K1 (BT and census) and the remap against a baseline build of the
same kernels, in turns on one card: baseline, change, change, baseline.

    python3 scripts/kernel_turns.py --baseline DIR [--out FILE] [--sass FILE]
                                    [--split DIR]

DIR holds the baseline's csrc/*.cu, built here with the port's nvcc flags.
Its K1 takes the six float32 planes of the BT prefilter and envelopes, or
the two planes of census words, computed in plain torch before the
launch (the interface before K1 fused them); its remap has the current C
signature. The change is the checkout's own library (ops/cuda_build.py).

Both versions run on the same inputs at 1080x1920, num_disp=128: the
seeded texture pair of chip_smoke.py (integer) and the same pair through
the mild rig's rectification (fractional). Every baseline output must equal
the change's bit for bit. Each entry is the device time of what a caller
runs (chip_smoke.time_ms: median of 7, enqueued behind a sleep kernel so
that host time does not count): for the baseline's K1 the plain-torch
inputs and the launch, for the change one launch.
torch.nn.functional.grid_sample on the same remap is timed in every turn
as the yardstick. One JSON line goes to stdout (and to --out); with
--sass, the SASS of the change's K1 at block_size 5 and of the remap,
with per-kernel opcode counts, goes to that file. With --split, two
copies of the change's K1 are built in DIR and timed at block_size 5: one
that returns after staging its shared-memory planes, and one that skips
the copy of its staged output to device memory; with the whole kernel
they split its time into staging, the loop, and the writes.

Imports nothing of JAX or depthestimation_tpu.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (texture pair, rig, timing helpers)
from depthestimation_torch import SGMConfig  # noqa: E402
from depthestimation_torch.calib import RectificationCache  # noqa: E402
from depthestimation_torch.ops import costs, cuda_build, cuda_sgm, remap  # noqa: E402

H, W, D = chip_smoke.H, chip_smoke.W, chip_smoke.D
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(csrc: Path, signatures) -> ctypes.CDLL:
    lib = csrc / "libkernels.so"
    cmd = [cuda_build._nvcc(), *cuda_build._FLAGS, "-o", str(lib),
           *map(str, sorted(csrc.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {csrc} failed:\n{proc.stdout}{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    for name, argtypes in signatures.items():
        fn = getattr(out, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return out


BASELINE_SIGNATURES = {"sgm_cost_volume": [_P] * 7 + [_I] * 5 + [_P],
                       "sgm_census_cost_volume": [_P] * 3 + [_I] * 5 + [_P],
                       "remap_bilinear": [_P] * 4 + [_I] * 3 + [_P]}

# Text edits of the change's sgm_kernels.cu for the split: (marker, what
# replaces it). Each marker must occur once.
SPLIT = {
    "staging_only": ("  const int d0 = min(dlo + warp * K, dhi - K + 1);",
                     "  if (D > 0) return;\n"
                     "  const int d0 = min(dlo + warp * K, dhi - K + 1);"),
    "no_device_write": ("        *reinterpret_cast<uint4*>(out + at) =",
                        "        if (D < 0) *reinterpret_cast<uint4*>(out + at) ="),
}


def split_libs(root: Path) -> dict:
    src = (cuda_build._CSRC / "sgm_kernels.cu").read_text()
    libs = {}
    for name, (marker, edit) in SPLIT.items():
        if src.count(marker) != 1:
            raise RuntimeError(f"split {name}: marker not found once in sgm_kernels.cu")
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sgm_kernels.cu").write_text(src.replace(marker, edit))
        libs[name] = build(d, {k: cuda_build._SIGNATURES[k] for k in
                               ("sgm_cost_volume", "sgm_census_cost_volume")})
    return libs


def sass_report(path: Path) -> str:
    """SASS of the change's K1 at block_size 5 (BT and census) and of the
    remap, each with its opcode counts."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cuda_build._lib_path())],
                          capture_output=True, text=True, check=True).stdout
    keep = []
    for part in re.split(r"(?=\n\s+Function : )", text):
        m = re.search(r"Function : (\S+)", part)
        if not m or not re.search(r"cost_volume_kernelILi5E|remap_kernel", m.group(1)):
            continue
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part))
        keep.append(f"== {m.group(1)}: {sum(ops.values())} instructions; "
                    + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
        keep.append(part)
    path.write_text("\n".join(keep))
    return "\n".join(line for line in keep if line.startswith("=="))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--split", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    smi = chip_smoke.smi_line()
    print(f"card: {smi}", file=sys.stderr)
    cuda_build.load_library()
    base = build(args.baseline, BASELINE_SIGNATURES)
    dev = torch.device("cuda")
    stream = cuda_build.stream

    left, right = chip_smoke.texture_pair(H, W, chip_smoke.SHIFT, seed=0)
    gl = torch.tensor(left[..., 0], dtype=torch.float32, device=dev)
    gr = torch.tensor(right[..., 0], dtype=torch.float32, device=dev)
    rig = SGMConfig().updated(**chip_smoke.mild_rig(H, W))
    mx, my = RectificationCache().device_maps(rig.calib, rig.baseline, 1.0, dev)
    pair = torch.stack([gl, gr])
    fl, fr = remap.remap_bilinear(pair, mx, my)
    cfg, cfgc = SGMConfig(num_disp=D), SGMConfig(num_disp=D, cost="census")

    def base_bt(lt, rt):
        pl_ = costs.xsobel_prefilter(lt, cfg.prefilter_cap)
        pr = costs.xsobel_prefilter(rt, cfg.prefilter_cap)
        planes = [pl_, *costs.half_sample_envelope(pl_),
                  pr, *costs.half_sample_envelope(pr)]
        out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
        cuda_build.launched("cost_volume", base.sgm_cost_volume(
            *(p.data_ptr() for p in planes), out.data_ptr(),
            H, W, D, cfg.min_disp, cfg.block_size, stream()))
        return out

    def base_census(lt, rt):
        cl, cr = costs.census_transform(lt), costs.census_transform(rt)
        out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
        cuda_build.launched("cost_volume_census", base.sgm_census_cost_volume(
            cl.data_ptr(), cr.data_ptr(), out.data_ptr(),
            H, W, D, cfgc.min_disp, cfgc.block_size, stream()))
        return out

    def base_remap():
        out = torch.empty_like(pair)
        cuda_build.launched("remap", base.remap_bilinear(
            pair.data_ptr(), mx.data_ptr(), my.data_ptr(), out.data_ptr(),
            2, H, W, stream()))
        return out

    grid = torch.stack([mx / (W - 1) * 2 - 1, my / (H - 1) * 2 - 1], -1)
    kernels = {
        "cost_volume": (lambda: base_bt(gl, gr),
                        lambda: cuda_sgm.cost_volume(gl, gr, cfg)),
        "cost_volume_fractional": (lambda: base_bt(fl, fr),
                                   lambda: cuda_sgm.cost_volume(fl, fr, cfg)),
        "cost_volume_census": (lambda: base_census(gl, gr),
                               lambda: cuda_sgm.cost_volume(gl, gr, cfgc)),
        "remap": (base_remap, lambda: remap.remap_bilinear(pair, mx, my)),
    }
    for name, (b, c) in kernels.items():
        err = chip_smoke.max_abs_err(b(), c())
        print(f"{name}: baseline vs change max_abs_err {err}", file=sys.stderr)
        if err != 0:
            raise AssertionError(f"{name}: the change differs from the baseline")

    turns = []
    for who in ("baseline", "change", "change", "baseline"):
        pick = 0 if who == "baseline" else 1
        row = {"who": who}
        for name, fns in kernels.items():
            row[name] = chip_smoke.time_ms(fns[pick])
        row["grid_sample"] = chip_smoke.time_ms(lambda: F.grid_sample(
            pair[:, None], grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        print(f"turn {row}", file=sys.stderr)
        turns.append(row)

    result = {"card": smi, "shape": [H, W, D], "turns": turns}
    if args.split:
        def launch(lib, census):
            out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
            if census:
                err = lib.sgm_census_cost_volume(
                    gl.data_ptr(), gr.data_ptr(), out.data_ptr(), H, W, D,
                    cfgc.min_disp, cfgc.block_size, stream())
            else:
                err = lib.sgm_cost_volume(
                    gl.data_ptr(), gr.data_ptr(), out.data_ptr(), H, W, D,
                    cfg.min_disp, cfg.block_size, cfg.prefilter_cap, stream())
            if err:
                raise RuntimeError(f"split launch failed: CUDA error {err}")
        libs = {"whole": cuda_build.load_library(), **split_libs(args.split)}
        result["k1_split"] = {
            name: {cost: chip_smoke.time_ms(lambda: launch(lib, cost == "census"))
                   for cost in ("bt", "census")}
            for name, lib in libs.items()}
        print(f"k1 split {result['k1_split']}", file=sys.stderr)
    if args.sass:
        print(sass_report(args.sass), file=sys.stderr)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
