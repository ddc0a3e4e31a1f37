"""Build and load the hand-written CUDA kernels (csrc/*.cu), and the
bookkeeping their wrappers share.

`nvcc` compiles the sources for sm_90a, one process per source, all
started together, and links them into one shared library with a plain C
interface, which is loaded with ctypes. The build runs at first
use, into ``build/`` at the repository root, keyed on a hash of the
sources and flags, so a fresh checkout builds everything on its first
kernel call and later processes reuse the library.

Every wrapper (ops/cuda_sgm.py, ops/remap.py, ops/filters.py, ops/wta.py)
takes a tensor on the CPU through its plain version and launches its
kernel for a tensor on the card; it never falls back. Each launch adds one to LAUNCHES[name], and
each wrapper call that launched its kernels adds one to CALLS[name].
A wrapper called while a CUDA graph is captured (graphs.py) counts as
well; the capture takes that change back (set_counts) and adds it again
on every replay (add_counts), so the counts are the launches the card
ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["LAUNCHES", "CALLS", "reset_launches", "counts", "set_counts", "add_counts",
           "load_library", "build_log"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMPILE = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Compile and link in one nvcc call (scripts/kernel_turns.py builds its
# baselines so).
_FLAGS = [*_COMPILE, "-shared"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures (csrc/*.cu); every function returns cudaError_t.
_SIGNATURES = {
    "sgm_cost_volume": [_P] * 3 + [_I] * 6 + [_P],
    "sgm_census_cost_volume": [_P] * 3 + [_I] * 5 + [_P],
    "sgm_hscan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sgm_rowsweep": [_P, _P, _I, _P, _I] + [_I] * 7 + [_P],
    "sgm_hscan_wide": [_P, _P, _P] + [_I] * 7 + [_P],
    "sgm_rowsweep_wide": [_P, _P, _I, _P, _I] + [_I] * 7 + [_P],
    "remap_bilinear": [_P] * 4 + [_I] * 3 + [_P],
    "speckle_filter": [_P] * 4 + [_I, _I, _F, _F, _I, _P],
    "wta_select": [_P, _I, _P] + [_I] * 6 + [_F, _P],
}

# Launch counts per kernel (K3 by direction set, K2 and K3 above 256
# disparities as their wide variants, see cuda_sgm.hscan and rowsweep; the
# speckle filter's four launches a call under one name; the WTA stage's one).
LAUNCHES = {name: 0 for name in (
    "cost_volume", "cost_volume_census", "hscan", "rowsweep", "rowsweep_up",
    "rowsweep_diag", "rowsweep_diag_up", "hscan_wide", "rowsweep_wide",
    "rowsweep_wide_up", "rowsweep_wide_diag", "rowsweep_wide_diag_up", "remap",
    "speckle", "wta")}
# Wrapper calls on the card per kernel, under the same names (a call of
# hscan makes 2 launches, a three-direction rowsweep pass 3), and the
# calls of the matcher's float32 route on any device
# (pipeline.float32_disparity, which launches no kernel of its own).
CALLS = dict.fromkeys((*LAUNCHES, "float32_route"), 0)

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path() -> Path:
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / h.hexdigest()[:16] / "libkernels.so"


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    library that load_library() loads; empty before the first build."""
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(tmp: Path, path: Path) -> None:
    """Compile every csrc/*.cu with its own nvcc, all started together,
    link the objects into one library and move it to path."""
    nvcc = _nvcc()
    sources = sorted(_CSRC.glob("*.cu"))
    objs = [tmp / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *_COMPILE, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    outs = [proc.communicate()[0] for proc in procs]
    for src, proc, out in zip(sources, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
    lib = tmp / "libkernels.so"
    link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(lib), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}{link.stderr}")
    path.with_suffix(".log").write_text("".join(outs) + link.stdout + link.stderr)
    os.replace(lib, path)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        # Build in a temporary directory and rename, so concurrent
        # processes never load a half-written library.
        with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
            _build(Path(tmp), path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def reset_launches() -> None:
    """Set every launch and call count to 0."""
    for counts_ in (LAUNCHES, CALLS):
        for name in counts_:
            counts_[name] = 0


def counts():
    """(LAUNCHES, CALLS) as copies."""
    return dict(LAUNCHES), dict(CALLS)


def set_counts(snapshot) -> None:
    """Set LAUNCHES and CALLS back to a counts() snapshot."""
    LAUNCHES.update(snapshot[0])
    CALLS.update(snapshot[1])


def add_counts(delta) -> None:
    """Add a (launches, calls) pair of dicts, as counts() gives them."""
    for total, more in zip((LAUNCHES, CALLS), delta):
        for name, n in more.items():
            total[name] += n


def on_card(t) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def check(t, what: str, dtype, shape, device) -> None:
    """Raise unless t is what a kernel takes: device, dtype, shape and
    contiguity."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def launched(name: str, err: int, n: int = 1) -> None:
    """Raise on a refused launch, else count it (n launches where one C
    call makes several)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += n


def called(name: str) -> None:
    """Count one wrapper call whose launches all went through."""
    CALLS[name] += 1


def stream() -> int:
    """The current CUDA stream, as the C functions take it: under a CUDA
    graph's capture that is the capturing stream, so every launch of the
    C functions lands in the graph."""
    import torch

    return torch.cuda.current_stream().cuda_stream
