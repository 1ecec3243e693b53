"""The port's native (C++) host runtime and its loader.

``fastx.cpp`` is a verbatim copy of ``smafa_tpu/native/fastx.cpp``
(importing ``smafa_tpu.native`` would load jax through
``smafa_tpu/__init__.py``). It holds the FASTX scan and fill behind
``io.fastx``, the postcard varint codec behind ``io.postcard``, the
threaded TSV formatters behind the query emit, the exact-duplicate set
behind the cluster dedup, and ``cross_hamming``, which is built but not
called: the port computes the cluster's distance blocks on the device.
The library loads with ctypes under the same signatures as
``smafa_tpu.native``.

It differs from ``smafa_tpu.native`` in two ways, on purpose:

- The build: ``g++`` writes the library to a temporary file in
  ``smafa_tpu_torch/_build/`` (git-ignored), which ``os.replace`` moves
  to a name that carries a hash of the source, the flags and the CPU's
  features (``-march=native`` code does not move between machines). So
  a process never loads a library that another one is still writing,
  and a changed source builds anew.
- A failed build raises ``NativeBuildError`` with g++'s output; nothing
  falls back to the pure-Python paths unseen.

``SMAFA_TPU_NO_NATIVE=1`` is the one way to the pure-Python paths (same
output, slower): ``load()`` then returns None. It is read on every call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "fastx.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX = "g++"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64, _i32, _vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
# name: (restype, argtypes), as smafa_tpu/native/__init__.py binds them
SIGNATURES = {
    "fastx_scan": (_i32, [_u8p, _i64, _i64p, _i64p, _i64p, _i32p]),
    "fastx_fill": (_i32, [_u8p, _i64, _u8p, _i64p, _u8p, _i64p, _u8p, _i32,
                          _i64p, _i64p, _i32p]),
    "postcard_encode_codes": (_i64, [_u8p, _i64, _i64, _u8p]),
    "postcard_encode_windows": (_i64, [_u64p, _i64, _i64, _u8p]),
    "postcard_decode_windows": (_i64, [_u8p, _i64, _i64, _i64, _u64p]),
    "unpack_words_codes": (_i32, [_u64p, _i64, _i64, _i64, _u8p, _i32p]),
    "tsv_format_bound": (_i64, [_i64, _i64]),
    "tsv_format": (_i64, [_i64p, _i32p, _i32p, _u8p, _i64p, _i64, _i64,
                          ctypes.c_char_p]),
    "tsv_format_mt": (_i64, [_i64p, _i32p, _i32p, _u8p, _i64p, _i64, _i64,
                             ctypes.c_char_p]),
    "tsv_format_codes_mt": (_i64, [_i64p, _i32p, _i32p, _u8p, _u8p, _i64,
                                   _i64, ctypes.c_char_p]),
    "dedup_new": (_vp, []),
    "dedup_free": (None, [_vp]),
    "dedup_filter": (_i64, [_vp, _u8p, _i64, _i64, _u8p]),
    "cross_hamming": (None, [_u8p, _i64, _u8p, _i64, _i64, _i32p]),
}


class NativeBuildError(RuntimeError):
    pass


def _disabled() -> bool:
    return os.environ.get("SMAFA_TPU_NO_NATIVE", "") not in ("", "0")


def _cpu_features() -> str:
    """The CPU's feature flags (Linux), else its architecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine()


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([CXX, *FLAGS, _cpu_features()]).encode())
    return BUILD_DIR / f"libsmafa_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``fastx.cpp`` unless the library for its hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{' '.join(cmd)}\n(exit {proc.returncode})\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a torn file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL | None:
    """The native library, built on first use; None only when
    ``SMAFA_TPU_NO_NATIVE`` asks for the pure-Python paths."""
    global _LIB
    if _disabled():
        return None
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB
