"""Build and load the hand-written CUDA kernels (csrc/*.cu), and the
bookkeeping their wrappers share.

`nvcc` compiles the sources for sm_90a into one shared library with a
plain C interface, which is loaded with ctypes. The build runs at first
use, into ``build/`` at the repository root, keyed on a hash of the
sources and flags, so a fresh checkout builds everything on its first
kernel call and later processes reuse the library.

Every wrapper (ops/cuda_sgm.py, ops/remap.py) takes a tensor on the CPU
through its plain version and launches its kernel for a tensor on the
card; it never falls back. Each launch adds one to LAUNCHES[name], and
each wrapper call that launched its kernels adds one to CALLS[name].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["LAUNCHES", "CALLS", "reset_launches", "load_library", "build_log"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures (csrc/*.cu); every function returns cudaError_t.
_SIGNATURES = {
    "sgm_cost_volume": [_P] * 3 + [_I] * 6 + [_P],
    "sgm_census_cost_volume": [_P] * 3 + [_I] * 5 + [_P],
    "sgm_hscan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sgm_rowsweep": [_P, _P, _I, _P, _I] + [_I] * 7 + [_P],
    "remap_bilinear": [_P] * 4 + [_I] * 3 + [_P],
}

# Launch counts per kernel (K3 by direction set; see cuda_sgm.rowsweep).
LAUNCHES = {name: 0 for name in (
    "cost_volume", "cost_volume_census", "hscan", "rowsweep", "rowsweep_up",
    "rowsweep_diag", "rowsweep_diag_up", "remap")}
# Wrapper calls on the card per kernel, under the same names (a call of
# hscan makes 2 launches, a three-direction rowsweep pass 3).
CALLS = dict.fromkeys(LAUNCHES, 0)

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


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        # Build under a temporary name and rename, so concurrent processes
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        cmd = [_nvcc(), *_FLAGS, "-o", tmp, *map(str, sorted(_CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def reset_launches() -> None:
    """Set every launch and call count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        CALLS[name] = 0


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


def launched(name: str, err: int) -> None:
    """Raise on a refused launch, else count it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def called(name: str) -> None:
    """Count one wrapper call whose launches all went through."""
    CALLS[name] += 1


def stream() -> int:
    """The current CUDA stream, as the C functions take it."""
    import torch

    return torch.cuda.current_stream().cuda_stream
