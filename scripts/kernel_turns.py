"""Time the port's kernels against a baseline build of them, in turns on one
card: baseline, change, change, baseline.

    python3 scripts/kernel_turns.py --baseline DIR [--out FILE] [--sass FILE]
                                    [--split DIR] [--rings DIR]
    python3 scripts/kernel_turns.py --wide --baseline DIR [--out FILE]
                                    [--rings DIR] [--other DIR]

DIR holds the baseline's csrc/*.cu, built here with the port's nvcc flags.
The baseline has the C interface of the change: K1 from the (H, W) float32
pair, sgm_hscan and sgm_rowsweep with their current signatures, the remap.
Each baseline call repeats what its wrapper does: K2 is two launches, and
a K3 pass is one launch per direction with the partial sums between
launches stored in the pass's out dtype. The change is the checkout's
own library through its wrappers (ops/cuda_sgm.py, ops/remap.py).

Both versions run on the same inputs at 1080x1920, num_disp=128: the seeded
texture pair of chip_smoke.py, its cost volume, and K3's four passes with
the storage types of sgbm_3way, hh4 and hh (chip_smoke.k3_passes), and one
diagonal direction alone (the bytes of a vertical pass). Every
baseline output must equal the change's bit for bit. Each entry is the
device time of one call (chip_smoke.time_ms: median of 7, enqueued behind a
sleep kernel so that host time does not count). For each kernel the line
also gives the bytes both designs move through device memory (each
launch reading its inputs once and writing its output once) and the rate
each reaches in the turns. torch.nn.functional.grid_sample on the same remap is
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

With --wide, the same turns for K2 and K3 above 256 disparities
(sgm_hscan_wide, sgm_rowsweep_wide) at each of WIDE_SHAPES: 1988x2964x288,
examples.stereo's full-size Middlebury matching, 1080x1920x272 (the
1080p pair just past 256, half as many rows) and 1080x1920x528 (past the
wide kernels' switch from registers to shared memory). The baseline is
an earlier build with the scratch-row wide interface, whose C functions
take a scratch of lines * 2 * (D + 16) int32 as their last argument
before the stream (WIDE_BASELINE); its partial sums are stored in the
pass's out dtype, as the wrappers do. Inputs: a seeded texture pair
moved 270 px, its cost volume, K2's sum and K3's four passes with the
storage types of sgbm_3way, hh4 and hh (chip_smoke.k3_passes), every
output bit-equal across the two builds. With --rings, the checkout's sgm_kernels.cu is
built at other wide ring depths (kWideRing) and K2 and K3's four passes
are held and timed at each depth at the first shape, depths up and then
down. With --other DIR, a build of DIR's sgm_kernels.cu with the
checkout's wide interface (another design of the wide kernels: e.g. a
copy with kLaneMax = 256 takes the shared-memory carry at every wide D)
is held to the checkout's outputs and timed against them in turns at
every shape, DIR's build in the baseline's place.

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


# Ring depths the --rings sweep builds (all but the checkout's own).
RINGS = (3, 4, 6, 8)


def constant(name: str) -> str:
    """The value of `constexpr <type> name = value;` in the checkout's
    sgm_kernels.cu, which must define it once."""
    found = re.findall(rf"constexpr \w+ {name} = (\w+);",
                       (cuda_build._CSRC / "sgm_kernels.cu").read_text())
    if len(found) != 1:
        raise RuntimeError(f"{name} not defined once in sgm_kernels.cu")
    return found[0]


def variant_lib(root: Path, name: str, value, functions) -> ctypes.CDLL:
    """The checkout's sgm_kernels.cu with the constant `name` set to
    `value`, built in root/<name><value>, binding `functions`."""
    src = (cuda_build._CSRC / "sgm_kernels.cu").read_text()
    d = root / f"{name}{value}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "sgm_kernels.cu").write_text(re.sub(
        rf"(constexpr \w+ {name} = )\w+;", rf"\g<1>{value};", src))
    return build(d, {k: cuda_build._SIGNATURES[k] for k in functions})


def ring_libs(root: Path, name: str, functions) -> tuple[int, dict]:
    """The checkout's ring depth `name` (kRing, or kWideRing with --wide),
    and {depth: library} of the change's sgm_kernels.cu built at each other
    depth of RINGS, binding `functions`."""
    own = int(constant(name))
    return own, {depth: variant_lib(root, name, depth, functions)
                 for depth in RINGS if depth != own}


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


def pass_bytes(acc_dt, out_dt, ndirs, n=N) -> int:
    """Bytes a K3 pass of ndirs launches over n cells moves: each launch
    reads C and the running sum and writes the next in out_dt."""
    return sum(n * (2 + nbytes(acc_dt if i == 0 else out_dt) + nbytes(out_dt))
               for i in range(ndirs))


def run_turns(kernels, extra=None) -> list:
    """Baseline, change, change, baseline: the device ms of each of
    `kernels` ({name: (baseline fn, change fn)}), and of each of `extra`
    ({name: fn}) in every turn."""
    turns = []
    for who in ("baseline", "change", "change", "baseline"):
        pick = 0 if who == "baseline" else 1
        row = {"who": who}
        for name, fns in kernels.items():
            row[name] = chip_smoke.time_ms(fns[pick])
        for name, fn in (extra or {}).items():
            row[name] = chip_smoke.time_ms(fn)
        print(f"turn {row}", file=sys.stderr)
        turns.append(row)
    return turns


def rates_of(turns, moved) -> dict:
    """Per kernel, the bytes both designs move ({name: bytes}) and the rate
    each reaches over the mean of its turns."""
    rates = {}
    for name, nbytes_ in moved.items():
        rates[name] = {"bytes": nbytes_}
        for who in ("baseline", "change"):
            ms = float(np.mean([t[name] for t in turns if t["who"] == who]))
            rates[name][f"tb_per_s_{who}"] = nbytes_ / ms / 1e9
        print(f"{name}: {rates[name]}", file=sys.stderr)
    return rates


def hold_equal(kernels) -> None:
    """Every output of the baseline (the first function of a pair) equals
    the change's bit for bit."""
    for name, (b, ch) in kernels.items():
        err = chip_smoke.max_abs_err(b(), ch())
        print(f"{name}: baseline vs change max_abs_err {err}", file=sys.stderr)
        if err != 0:
            raise AssertionError(f"{name}: the change differs from the baseline")


# (h, w, D) of the --wide turns: examples.stereo's full-size Middlebury
# matching (D = 288, 16 disparities a lane in registers), and at 1080p D
# = 272 (the first wide D, half as many rows) and 528 (the carry in
# shared memory).
WIDE_SHAPES = ((1988, 2964, 288), (1080, 1920, 272), (1080, 1920, 528))
WIDE_SHIFT = 270
# The scratch-row wide C functions: a scratch pointer before the stream.
_P, _I = ctypes.c_void_p, ctypes.c_int
WIDE_BASELINE = {
    "sgm_hscan_wide": [_P, _P, _P] + [_I] * 7 + [_P, _P],
    "sgm_rowsweep_wide": [_P, _P, _I, _P, _I] + [_I] * 7 + [_P, _P],
}


def wide_main(args, smi) -> dict:
    """The --wide turns (module docstring)."""
    base = build(args.baseline, WIDE_BASELINE)
    other = args.other and build(args.other, {
        k: cuda_build._SIGNATURES[k] for k in ("sgm_hscan_wide", "sgm_rowsweep_wide")})
    result = {"card": smi, "shapes": {}}
    for i, (h, w, d) in enumerate(WIDE_SHAPES):
        result["shapes"][f"{h}x{w}x{d}"] = wide_shape(
            base, h, w, d, args.rings if i == 0 else None, other)
        torch.cuda.empty_cache()
    return result


def wide_shape(base, h, w, d, rings_dir, other) -> dict:
    """The --wide turns at one (h, w, d); with rings_dir the kWideRing
    sweep, with other (a library) its turns against the checkout."""
    dev = torch.device("cuda")
    stream = cuda_build.stream
    n = h * w * d
    left, right = chip_smoke.texture_pair(h, w, WIDE_SHIFT, seed=d)
    gl, gr = (torch.tensor(img[..., 0], dtype=torch.float32, device=dev)
              for img in (left, right))
    del left, right
    cfg = SGMConfig(num_disp=d)
    cfg4, cfg8 = SGMConfig(num_disp=d, sgbm_mode="hh4"), SGMConfig(num_disp=d, sgbm_mode="hh")
    c = cuda_sgm.cost_volume(gl, gr, cfg)
    del gl, gr
    swe = cuda_sgm.hscan(c, cfg)
    k3 = chip_smoke.k3_passes(c, swe, cfg, cfg4, cfg8)

    def scratch(lines):
        return torch.empty(lines * 2 * (d + 16), dtype=torch.int32, device=dev)

    def lib_hscan(lib=base):
        acc_dt = cuda_sgm._acc_dtype(cfg)
        l_lr = torch.empty_like(c)
        extra = (scratch(h).data_ptr(),) if lib is base else ()
        err = lib.sgm_hscan_wide(c.data_ptr(), None, l_lr.data_ptr(), 0, 0, h, w, d,
                                 cfg.p1, cfg.p2, *extra, stream())
        out = torch.empty((h, w, d), dtype=acc_dt, device=dev)
        err = err or lib.sgm_hscan_wide(c.data_ptr(), l_lr.data_ptr(), out.data_ptr(),
                                        int(acc_dt == torch.int32), 1, h, w, d,
                                        cfg.p1, cfg.p2, *extra, stream())
        if err:
            raise RuntimeError(f"sgm_hscan_wide failed: CUDA error {err}")
        return out

    def lib_rowsweep(acc, kcfg, dxs, reverse, out_dtype, lib=base):
        for dx in dxs:
            out = torch.empty((h, w, d), dtype=out_dtype, device=dev)
            extra = (scratch(w if dx == 0 else w + h - 1).data_ptr(),) if lib is base else ()
            err = lib.sgm_rowsweep_wide(
                c.data_ptr(), acc.data_ptr(), int(acc.dtype == torch.int32),
                out.data_ptr(), int(out_dtype == torch.int32), h, w, d,
                -1 if reverse else 1, dx, kcfg.p1, kcfg.p2, *extra, stream())
            if err:
                raise RuntimeError(f"sgm_rowsweep_wide failed: CUDA error {err}")
            acc = out
        return acc

    kernels = {"hscan_wide": (lib_hscan, lambda: cuda_sgm.hscan(c, cfg))}
    moved = {"hscan_wide": n * (8 + swe.element_size())}
    for name, (acc, kcfg, dxs, rev, dt) in k3.items():
        kernels[name] = (
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: lib_rowsweep(a, k, x, r, t),
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: cuda_sgm.rowsweep(c, a, k, x, r, t))
        moved[name] = pass_bytes(acc.dtype, dt, len(dxs), n)
    hold_equal(kernels)
    turns = run_turns(kernels)
    shape = {"turns": turns, "moved": rates_of(turns, moved)}
    if rings_dir:
        own, libs = ring_libs(rings_dir, "kWideRing",
                              ("sgm_hscan_wide", "sgm_rowsweep_wide"))
        libs[own] = cuda_build.load_library()
        scans = {"hscan_wide": lib_hscan}
        for name, (acc, kcfg, dxs, rev, dt) in k3.items():
            scans[name] = (lambda lib, a=acc, k=kcfg, x=dxs, r=rev, t=dt:
                           lib_rowsweep(a, k, x, r, t, lib=lib))
        for depth, lib in libs.items():
            for name, fn in scans.items():
                if chip_smoke.max_abs_err(fn(lib), kernels[name][1]()) != 0:
                    raise AssertionError(f"kWideRing {depth}: {name} differs from the change")
        depths = sorted(libs)
        rings = {dp: {name: [] for name in scans} for dp in depths}
        for dp in depths + depths[::-1]:
            for name, fn in scans.items():
                rings[dp][name].append(chip_smoke.time_ms(lambda: fn(libs[dp])))
        shape["rings"] = {"own": own, "ms": rings}
        print(f"wide rings (own kWideRing {own}): {rings}", file=sys.stderr)
    if other:
        pairs = {"hscan_wide": (lambda: lib_hscan(other), kernels["hscan_wide"][1])}
        for name, (acc, kcfg, dxs, rev, dt) in k3.items():
            pairs[name] = (lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt:
                           lib_rowsweep(a, k, x, r, t, lib=other), kernels[name][1])
        hold_equal(pairs)
        shape["other"] = run_turns(pairs)
    return shape


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--split", type=Path)
    ap.add_argument("--rings", type=Path)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--other", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    smi = chip_smoke.smi_line()
    print(f"card: {smi}", file=sys.stderr)
    cuda_build.load_library()
    if args.wide:
        return emit(wide_main(args, smi), args.out)
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

    def lib_hscan(lib=base):
        acc_dt = cuda_sgm._acc_dtype(cfg)
        l_lr = torch.empty_like(c)
        run("sgm_hscan", c.data_ptr(), None, l_lr.data_ptr(), 0, 0, H, W, D,
            cfg.p1, cfg.p2, stream(), lib=lib)
        out = torch.empty((H, W, D), dtype=acc_dt, device=dev)
        run("sgm_hscan", c.data_ptr(), l_lr.data_ptr(), out.data_ptr(),
            int(acc_dt == torch.int32), 1, H, W, D, cfg.p1, cfg.p2, stream(),
            lib=lib)
        return out

    def lib_rowsweep(acc, kcfg, dxs, reverse, out_dtype, lib=base):
        for dx in dxs:
            out = torch.empty((H, W, D), dtype=out_dtype, device=dev)
            run("sgm_rowsweep", c.data_ptr(), acc.data_ptr(),
                int(acc.dtype == torch.int32), out.data_ptr(),
                int(out_dtype == torch.int32), H, W, D, -1 if reverse else 1, dx,
                kcfg.p1, kcfg.p2, stream(), lib=lib)
            acc = out
        return acc

    kernels = {
        "cost_volume": (lambda: base_cost(cfg),
                        lambda: cuda_sgm.cost_volume(gl, gr, cfg)),
        "cost_volume_census": (lambda: base_cost(cfgc),
                               lambda: cuda_sgm.cost_volume(gl, gr, cfgc)),
        "remap": (base_remap, lambda: remap.remap_bilinear(pair, mx, my)),
        "hscan": (lib_hscan, lambda: cuda_sgm.hscan(c, cfg)),
    }
    # Bytes both designs move.
    moved = {
        "cost_volume": 2 * H * W * 4 + N * 2,
        "cost_volume_census": 2 * H * W * 4 + N * 2,
        "remap": 2 * H * W * 4 * 4,
        "hscan": N * (8 + swe.element_size()),
    }
    for name, (acc, kcfg, dxs, rev, dt) in k3.items():
        kernels[name] = (
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: lib_rowsweep(a, k, x, r, t),
            lambda a=acc, k=kcfg, x=dxs, r=rev, t=dt: cuda_sgm.rowsweep(c, a, k, x, r, t))
        moved[name] = pass_bytes(acc.dtype, dt, len(dxs))
    # One diagonal direction alone: one launch, the bytes of a vertical pass,
    # against which the vertical pass shows what the diagonal lines'
    # unequal lengths cost.
    acc8 = cuda_sgm._acc_dtype(cfg8)
    kernels["rowsweep_one_diagonal"] = (
        lambda: lib_rowsweep(swe, cfg8, (1,), False, acc8),
        lambda: cuda_sgm.rowsweep(c, swe, cfg8, (1,), False, acc8))
    moved["rowsweep_one_diagonal"] = pass_bytes(swe.dtype, acc8, 1)

    hold_equal(kernels)
    grid = torch.stack([mx / (W - 1) * 2 - 1, my / (H - 1) * 2 - 1], -1)
    turns = run_turns(kernels, {"grid_sample": lambda: F.grid_sample(
        pair[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)})
    result = {"card": smi, "shape": [H, W, D], "turns": turns,
              "moved": rates_of(turns, moved)}
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
        own, libs = ring_libs(args.rings, "kRing", ("sgm_hscan", "sgm_rowsweep"))
        libs[own] = cuda_build.load_library()
        scans = {"hscan": lambda lib: lib_hscan(lib)}
        for name in ("rowsweep", "rowsweep_diag"):
            acc, kcfg, dxs, rev, dt = k3[name]
            scans[name] = (lambda lib, a=acc, k=kcfg, x=dxs, r=rev, t=dt:
                           lib_rowsweep(a, k, x, r, t, lib=lib))
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
    return emit(result, args.out)


def emit(result, out) -> int:
    """Print the result's JSON line (and write it to out)."""
    line = json.dumps(result)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
