"""Time the port's kernels against a baseline build of them, in turns on one
card: baseline, change, change, baseline.

    python3 scripts/kernel_turns.py --baseline DIR [--out FILE] [--sass FILE]
                                    [--split DIR] [--rings DIR]

DIR holds the baseline's csrc/*.cu, built here with the port's nvcc flags.
The baseline has the C interface of the change: K1 from the (H, W) float32
pair, sgm_hscan and sgm_rowsweep with their current signatures, the remap.
Each baseline call repeats what its wrapper did at that build: K2 is two
launches, and a K3 pass is one launch per direction with the partial sums
between launches stored as int32. The change is the checkout's own library
through its wrappers (ops/cuda_sgm.py, ops/remap.py).

Both versions run on the same inputs at 1080x1920, num_disp=128: the seeded
texture pair of chip_smoke.py, its cost volume, and K3's four passes with
the storage types of sgbm_3way, hh4 and hh (chip_smoke.k3_passes), and one
diagonal direction alone (the bytes of a vertical pass). Every
baseline output must equal the change's bit for bit. Each entry is the
device time of one call (chip_smoke.time_ms: median of 7, enqueued behind a
sleep kernel so that host time does not count). For each kernel the line
also gives the bytes each design moves through device memory (each launch
reading its inputs once and writing its output once) and the rate that
makes in the turns. torch.nn.functional.grid_sample on the same remap is
timed in every turn as a yardstick.

One JSON line goes to stdout (and to --out). With --sass, the SASS of the
change's K1 at block_size 5, the remap, and K2 and K3 at K = 4 (D = 128),
with per-kernel opcode counts, goes to that file. With --split, two copies
of the change's K1 are built in DIR and timed at block_size 5: one that
returns after staging its shared-memory planes, and one that skips the copy
of its staged output to device memory; with the whole kernel they split its
time into staging, the loop, and the writes. With --rings, copies of the
change's sgm_kernels.cu with other ring depths (kRing, the stages of each
warp's load ring in K2 and K3) are built in DIR; K2 and K3's vertical and
three-direction passes at each depth, the checkout's included, must equal
the change's outputs and are timed in turns, depths up and then down.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (texture pair, rig, K3 inputs, timing)
from depthestimation_torch import SGMConfig  # noqa: E402
from depthestimation_torch.calib import RectificationCache  # noqa: E402
from depthestimation_torch.ops import cuda_build, cuda_sgm, remap  # noqa: E402

H, W, D = chip_smoke.H, chip_smoke.W, chip_smoke.D
N = H * W * D


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


# Text edits of the change's sgm_kernels.cu for the split: (marker, what
# replaces it). Each marker must occur once.
SPLIT = {
    "staging_only": ("  const int d0 = min(dlo + warp * K, dhi - K + 1);",
                     "  if (D > 0) return;\n"
                     "  const int d0 = min(dlo + warp * K, dhi - K + 1);"),
    "no_device_write": ("        *reinterpret_cast<uint4*>(out + at) =",
                        "        if (D < 0) *reinterpret_cast<uint4*>(out + at) ="),
}


# Ring depths the --rings sweep builds besides the checkout's.
RINGS = (3, 6, 8)
RING_DEF = re.compile(r"constexpr int kRing = (\d+);")


def ring_libs(root: Path) -> tuple[int, dict]:
    """The checkout's kRing, and {depth: library} of the change's K2/K3
    built at each depth of RINGS."""
    src = (cuda_build._CSRC / "sgm_kernels.cu").read_text()
    found = RING_DEF.findall(src)
    if len(found) != 1:
        raise RuntimeError("--rings: kRing not defined once in sgm_kernels.cu")
    libs = {}
    for depth in RINGS:
        d = root / f"ring{depth}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "sgm_kernels.cu").write_text(
            RING_DEF.sub(f"constexpr int kRing = {depth};", src))
        libs[depth] = build(d, {k: cuda_build._SIGNATURES[k] for k in
                                ("sgm_hscan", "sgm_rowsweep")})
    return int(found[0]), libs


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


# The C functions the baseline is called through (the interface since K1
# took the grayscale pair).
BASELINE = ("sgm_cost_volume", "sgm_census_cost_volume", "sgm_hscan",
            "sgm_rowsweep", "remap_bilinear")

SASS_KERNELS = (r"cost_volume_kernelILi5E|remap_kernel|hscan_kernelILi4E"
                r"|rowsweep_kernelILi4E")


def sass_report(path: Path) -> str:
    """SASS of the change's kernels named by SASS_KERNELS, each with its
    opcode counts."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cuda_build._lib_path())],
                          capture_output=True, text=True, check=True).stdout
    keep = []
    for part in re.split(r"(?=\n\s+Function : )", text):
        m = re.search(r"Function : (\S+)", part)
        if not m or not re.search(SASS_KERNELS, m.group(1)):
            continue
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part))
        keep.append(f"== {m.group(1)}: {sum(ops.values())} instructions; "
                    + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
        keep.append(part)
    path.write_text("\n".join(keep))
    return "\n".join(line for line in keep if line.startswith("=="))


def nbytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def pass_bytes(acc_dt, out_dt, ndirs, partial_dt) -> int:
    """Bytes a K3 pass of ndirs launches moves: each launch reads C and the
    running sum and writes the next, the last one in out_dt."""
    total, a = 0, acc_dt
    for i in range(ndirs):
        o = out_dt if i == ndirs - 1 else partial_dt
        total += N * (2 + nbytes(a) + nbytes(o))
        a = o
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--split", type=Path)
    ap.add_argument("--rings", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    smi = chip_smoke.smi_line()
    print(f"card: {smi}", file=sys.stderr)
    cuda_build.load_library()
    base = build(args.baseline, {k: cuda_build._SIGNATURES[k] for k in BASELINE})
    dev = torch.device("cuda")
    stream = cuda_build.stream

    def run(fn, *a, lib=base):
        err = getattr(lib, fn)(*a)
        if err:
            raise RuntimeError(f"{fn} failed: CUDA error {err}")

    left, right = chip_smoke.texture_pair(H, W, chip_smoke.SHIFT, seed=0)
    gl = torch.tensor(left[..., 0], dtype=torch.float32, device=dev)
    gr = torch.tensor(right[..., 0], dtype=torch.float32, device=dev)
    rig = SGMConfig().updated(**chip_smoke.mild_rig(H, W))
    mx, my = RectificationCache().device_maps(rig.calib, rig.baseline, 1.0, dev)
    pair = torch.stack([gl, gr])
    cfg, cfgc = SGMConfig(num_disp=D), SGMConfig(num_disp=D, cost="census")
    cfg4 = SGMConfig(num_disp=D, sgbm_mode="hh4")
    cfg8 = SGMConfig(num_disp=D, sgbm_mode="hh")
    c = cuda_sgm.cost_volume(gl, gr, cfg)
    swe = cuda_sgm.hscan(c, cfg)
    k3 = chip_smoke.k3_passes(c, swe, cfg, cfg4, cfg8)

    def base_cost(kcfg):
        out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
        if kcfg.cost == "census":
            run("sgm_census_cost_volume", gl.data_ptr(), gr.data_ptr(),
                out.data_ptr(), H, W, D, kcfg.min_disp, kcfg.block_size, stream())
        else:
            run("sgm_cost_volume", gl.data_ptr(), gr.data_ptr(), out.data_ptr(),
                H, W, D, kcfg.min_disp, kcfg.block_size, kcfg.prefilter_cap,
                stream())
        return out

    def base_remap():
        out = torch.empty_like(pair)
        run("remap_bilinear", pair.data_ptr(), mx.data_ptr(), my.data_ptr(),
            out.data_ptr(), 2, H, W, stream())
        return out

    def base_hscan(lib=base):
        acc_dt = cuda_sgm._acc_dtype(cfg)
        l_lr = torch.empty_like(c)
        run("sgm_hscan", c.data_ptr(), None, l_lr.data_ptr(), 0, 0, H, W, D,
            cfg.p1, cfg.p2, stream(), lib=lib)
        out = torch.empty((H, W, D), dtype=acc_dt, device=dev)
        run("sgm_hscan", c.data_ptr(), l_lr.data_ptr(), out.data_ptr(),
            int(acc_dt == torch.int32), 1, H, W, D, cfg.p1, cfg.p2, stream(),
            lib=lib)
        return out

    def base_rowsweep(acc, kcfg, dxs, reverse, out_dtype, lib=base,
                      partial=torch.int32):
        for i, dx in enumerate(dxs):
            dt = out_dtype if i == len(dxs) - 1 else partial
            out = torch.empty((H, W, D), dtype=dt, device=dev)
            run("sgm_rowsweep", c.data_ptr(), acc.data_ptr(),
                int(acc.dtype == torch.int32), out.data_ptr(),
                int(dt == torch.int32), H, W, D, -1 if reverse else 1, dx,
                kcfg.p1, kcfg.p2, stream(), lib=lib)
            acc = out
        return acc

    kernels = {
        "cost_volume": (lambda: base_cost(cfg),
                        lambda: cuda_sgm.cost_volume(gl, gr, cfg)),
        "cost_volume_census": (lambda: base_cost(cfgc),
                               lambda: cuda_sgm.cost_volume(gl, gr, cfgc)),
        "remap": (base_remap, lambda: remap.remap_bilinear(pair, mx, my)),
        "hscan": (base_hscan, lambda: cuda_sgm.hscan(c, cfg)),
    }
    # Bytes each design moves: (baseline, change).
    moved = {
        "cost_volume": (2 * H * W * 4 + N * 2,) * 2,
        "cost_volume_census": (2 * H * W * 4 + N * 2,) * 2,
        "remap": (2 * H * W * 4 * 4,) * 2,
        "hscan": (N * (8 + swe.element_size()),) * 2,
    }
    for name, (acc, kcfg, dxs, rev, dt) in k3.items():
        kernels[name] = (
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: base_rowsweep(a, k, x, r, t),
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: cuda_sgm.rowsweep(c, a, k, x, r, t))
        moved[name] = (pass_bytes(acc.dtype, dt, len(dxs), torch.int32),
                       pass_bytes(acc.dtype, dt, len(dxs), dt))
    # One diagonal direction alone: one launch, the bytes of a vertical pass,
    # against which the vertical pass shows what the diagonal lines'
    # unequal lengths cost.
    acc8 = cuda_sgm._acc_dtype(cfg8)
    kernels["rowsweep_one_diagonal"] = (
        lambda: base_rowsweep(swe, cfg8, (1,), False, acc8),
        lambda: cuda_sgm.rowsweep(c, swe, cfg8, (1,), False, acc8))
    moved["rowsweep_one_diagonal"] = (pass_bytes(swe.dtype, acc8, 1, acc8),) * 2

    for name, (b, ch) in kernels.items():
        err = chip_smoke.max_abs_err(b(), ch())
        print(f"{name}: baseline vs change max_abs_err {err}", file=sys.stderr)
        if err != 0:
            raise AssertionError(f"{name}: the change differs from the baseline")

    grid = torch.stack([mx / (W - 1) * 2 - 1, my / (H - 1) * 2 - 1], -1)
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

    rates = {}
    for name, (b_bytes, c_bytes) in moved.items():
        ms = {who: float(np.mean([t[name] for t in turns if t["who"] == who]))
              for who in ("baseline", "change")}
        rates[name] = {
            "bytes_baseline": b_bytes, "bytes_change": c_bytes,
            "tb_per_s_baseline": b_bytes / ms["baseline"] / 1e9,
            "tb_per_s_change": c_bytes / ms["change"] / 1e9,
        }
        print(f"{name}: {rates[name]}", file=sys.stderr)

    result = {"card": smi, "shape": [H, W, D], "turns": turns, "moved": rates}
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
    if args.rings:
        # K2 and K3 as the change's wrappers call them (partial sums in the
        # pass's out dtype), through each depth's library.
        own, libs = ring_libs(args.rings)
        libs[own] = cuda_build.load_library()
        scans = {"hscan": lambda lib: base_hscan(lib)}
        for name in ("rowsweep", "rowsweep_diag"):
            acc, kcfg, dxs, rev, dt = k3[name]
            scans[name] = (lambda lib, a=acc, k=kcfg, x=dxs, r=rev, t=dt:
                           base_rowsweep(a, k, x, r, t, lib=lib, partial=t))
        for depth, lib in libs.items():
            for name, fn in scans.items():
                if chip_smoke.max_abs_err(fn(lib), kernels[name][1]()) != 0:
                    raise AssertionError(f"ring {depth}: {name} differs from the change")
        depths = sorted(libs)
        rings = {d: {name: [] for name in scans} for d in depths}
        for d in depths + depths[::-1]:
            for name, fn in scans.items():
                rings[d][name].append(chip_smoke.time_ms(lambda: fn(libs[d])))
        result["rings"] = {"own": own, "ms": rings}
        print(f"rings (own kRing {own}): {rings}", file=sys.stderr)
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
