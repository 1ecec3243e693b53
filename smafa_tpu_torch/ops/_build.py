"""Build and load the port's CUDA kernels.

Every ``smafa_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, under
``smafa_tpu_torch/_build/`` (git-ignored). The build runs at first use
and again whenever a source changes (the library's file name carries a
hash of the sources). The library loads with ``ctypes``; every pointer
and the stream are passed as ``c_void_p``. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path

logger = logging.getLogger("smafa")

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, db, zc, lo, hi, cnt, B, W, EP, seq_len, shift, with_count, stream
    "smafa_min2": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, db, zc, thresh, mask, B, W, EP, seq_len, stream
    "smafa_compact_mask": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    pass


class _Loaded:
    """The library, once loaded in this process."""

    lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(cuda_home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsmafa_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    logger.info("Building CUDA kernels: %s", " ".join(cmd))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a torn file
    logger.info("CUDA kernels built in %.1fs", time.perf_counter() - t0)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    if _Loaded.lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _Loaded.lib = lib
    return _Loaded.lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
