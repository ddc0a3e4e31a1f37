"""The yardstick's kernel arithmetic: the card's peaks, the bytes and
operations of one call of each hand-written SGM kernel, its least time,
and which kernel names the port's hand-written kernels carry.

Frozen here so that a change to the program cannot move it. The byte
counts read each input once and write each output once; at 1080x1920 and
128 disparities they give K1 0.163 ms, K2 0.317 ms and K3 0.475 ms
(int16 partial sums and output).
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM (data sheet, dense, 700 W): HBM rate and the float32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The SGM matcher's kernels by name prefix (K1, K2, K3, and their wide
# variants above 256 disparities), and every hand-written kernel's.
SGM_PREFIXES = ("cost_volume", "hscan", "rowsweep")
HAND_WRITTEN_PREFIXES = SGM_PREFIXES + ("remap_kernel",)
# Device operations that are copies or fills, not kernels.
COPY_PREFIXES = ("Memcpy", "Memset")

# Path count of each sgbm_mode, and the K3 passes it runs as (number of
# directions, reverse) per pass.
MODE_PATHS = {"sgbm": 5, "hh": 8, "sgbm_3way": 3, "hh4": 4}
SWEEPS = {3: [1], 4: [1, 1], 5: [3], 8: [3, 3]}


def base_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters, from a demangled name ("void
    (anonymous namespace)::hscan_kernel<4, false, short>(...)") or a
    mangled one ("_Z12hscan_kernelILi4ELb0EsEv...")."""
    if name.startswith("_Z"):
        digits = re.match(r"_ZN?(\d+)", name)
        if digits:
            start = digits.end()
            return name[start:start + int(digits.group(1))]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1]


def is_sgm(name: str) -> bool:
    return base_name(name).startswith(SGM_PREFIXES)


def is_hand_written(name: str) -> bool:
    return base_name(name).startswith(HAND_WRITTEN_PREFIXES)


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def _cmax(sgm: dict) -> int:
    per_pixel = 24 if sgm["cost"] == "census" else 2 * sgm["prefilter_cap"]
    return sgm["block_size"] ** 2 * per_pixel


def _p2(sgm: dict) -> int:
    return 32 * sgm["block_size"] ** 2


def acc_bytes(sgm: dict) -> int:
    """Bytes of a stored partial sum: int16 where the directions summed
    into the largest one fit below 32600 at their worst case, else int32."""
    stored = {3: 2, 4: 3, 5: 2, 8: 5}[MODE_PATHS[sgm["sgbm_mode"]]]
    return 2 if stored * (_cmax(sgm) + 3 * _p2(sgm)) < 32600 else 4


def final_bytes(sgm: dict) -> int:
    """Bytes of an element of the final aggregated volume."""
    paths = MODE_PATHS[sgm["sgbm_mode"]]
    return 2 if paths * (_cmax(sgm) + _p2(sgm)) < 32600 else 4


def kernel_work(name, h, w, d, acc=2, out=2, dirs=1):
    """(bytes, operations) of one call at (h, w, d): each input read once,
    each output written once. Operations per (y, x, d): K1 BT the pixel
    cost (10) plus a separable running box sum (4), census XOR and
    popcount (2) plus the box sum; K2 two scan steps (9 each) plus the
    sum; K3 one scan step plus the sum a direction."""
    n = h * w * d
    if name.startswith("cost_volume"):
        return 2 * h * w * 4 + n * 2, n * (6 if name.endswith("census") else 14)
    if name.startswith("hscan"):
        return n * (2 + acc), n * 19
    return n * (2 + acc + out), n * 10 * dirs


def bound_ms(nbytes, nops) -> float:
    """Least ms: the larger of the bytes over the memory rate and the
    operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3


def sgm_launch_bounds(config: dict) -> dict:
    """Least ms a launch of each SGM kernel (by name prefix) at the
    configuration's (height, width, num_disp): a K2 call is two launches
    and a K3 pass one launch a direction, so a call's bound is shared out
    over its launches. Where a mode's K3 passes differ in output type
    (hh4, hh with int32 sums), a K3 launch takes their mean."""
    sgm = config["sgm"]
    h, w, d = config["height"], config["width"], sgm["num_disp"]
    acc, fin = acc_bytes(sgm), final_bytes(sgm)
    k1 = "cost_volume_census" if sgm["cost"] == "census" else "cost_volume"
    sweeps = SWEEPS[MODE_PATHS[sgm["sgbm_mode"]]]
    k3 = [bound_ms(*kernel_work("rowsweep", h, w, d, acc, fin if i == len(sweeps) - 1 else acc,
                                dirs)) / dirs for i, dirs in enumerate(sweeps)]
    return {
        "cost_volume": bound_ms(*kernel_work(k1, h, w, d)),
        "hscan": bound_ms(*kernel_work("hscan", h, w, d, acc)) / 2,
        "rowsweep": sum(k3) / len(k3),
    }
