"""Build and load the port's CUDA kernels.

Every ``smafa_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together), and the
objects link into one shared library with a plain C interface, under
``smafa_tpu_torch/_build/`` (git-ignored). The build runs at first use
and again whenever a source or header changes (the library's file name
carries a hash of them). The library loads with ``ctypes``; every
pointer and the stream are passed as ``c_void_p``. A failed build
raises. ``ptxas -v`` reports each kernel's registers, shared memory and
spills; ``compile_log`` keeps that output of the last build in this
process, per source.
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, db, zc, lo, hi, cnt, part, B, W, EP, seq_len, shift, with_count,
    # splits, stream
    "smafa_min2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _P],
    # q, db, zc, thresh, mask, B, W, EP, seq_len, splits, stream
    "smafa_compact_mask": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, db, zc, key, cnt, part, B, n_valid, EP, seq_len, shift, with_count,
    # splits, stream
    "smafa_min_count": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    # q, db, zc, ts, cnt, mx, part, B, n_valid, EP, seq_len, splits, stream
    "smafa_kstats": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, db, zc, dist, B, W, EP, seq_len, splits, stream
    "smafa_dist_block": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, db, zc, hist, B, n_valid, EP, seq_len, splits, stream
    "smafa_hist": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    pass


compile_log: dict[str, str] = {}


class _Loaded:
    """The library, once loaded in this process."""

    lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _hashed_files() -> list[Path]:
    return sorted([*_sources(), *CSRC.glob("*.cuh")])


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
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libsmafa_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel and return their outputs; raise with
    the output of each that failed. No process outlives the call."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed, texts = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            text, _ = proc.communicate()
            texts.append(text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n(exit {proc.returncode})\n{text}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return texts


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, sources = _nvcc(), _sources()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    logger.info("Building CUDA kernels: %s", " ".join(s.name for s in sources))
    t0 = time.perf_counter()
    try:
        texts = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                          for src, obj in zip(sources, objs)])
        compile_log.update((src.name, text) for src, text in zip(sources, texts))
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent build never sees a torn file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
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
