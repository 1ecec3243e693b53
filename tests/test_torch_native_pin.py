"""The port's native runtime (smafa_tpu_torch.native) against smafa_tpu's:
the C++ source is a byte-for-byte copy, the Python modules around it are
copies apart from the package name, the ctypes signatures are the same;
importing them loads neither jax nor torch, nor does collecting the
tests load torch; and the loader's two
differences: it builds under a hashed name by an atomic rename (two
processes building at once both load a whole library), and a failed
build raises rather than fall back."""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import pytest

from smafa_tpu import native as N0
from smafa_tpu_torch import native as N1

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_fastx_cpp_byte_identical():
    assert ((ROOT / "smafa_tpu_torch" / "native" / "fastx.cpp").read_bytes()
            == (ROOT / "smafa_tpu" / "native" / "fastx.cpp").read_bytes())


@pytest.mark.parametrize("module", [
    "native/ingest.py", "io/fastx.py", "io/postcard.py", "utils/testing.py",
])
def test_copied_module_source_pinned(module):
    """Verbatim copies: only the package name differs."""
    orig = (ROOT / "smafa_tpu" / module).read_text()
    port = (ROOT / "smafa_tpu_torch" / module).read_text()
    assert port.replace("smafa_tpu_torch.", "smafa_tpu.") == orig


def test_signature_table_equals_reference():
    """Every function smafa_tpu binds, bound here with the same types."""
    src = (ROOT / "smafa_tpu" / "native" / "__init__.py").read_text()
    names = set(re.findall(r"lib\.(\w+)\.argtypes", src))
    assert names == set(N1.SIGNATURES)
    lib0, lib1 = N0.load(), N1.load()
    assert lib0 is not None and lib1 is not None
    for name in sorted(names):
        f0, f1 = getattr(lib0, name), getattr(lib1, name)
        assert (f1.restype, f1.argtypes) == (f0.restype, f0.argtypes), name


def test_import_loads_no_jax_or_torch():
    """In a fresh interpreter (the session's conftest imports jax): the
    host modules, the native library loaded and used, and no jax, torch
    or smafa_tpu module in sys.modules."""
    code = ("import sys; from smafa_tpu_torch import native; "
            "import smafa_tpu_torch.native.ingest, smafa_tpu_torch.io.fastx, "
            "smafa_tpu_torch.io.postcard, smafa_tpu_torch.utils.testing; "
            "assert native.load().tsv_format_bound(1, 3) > 0; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'torch', 'triton', 'smafa_tpu')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_collection_loads_no_torch():
    """Collecting the tests imports no torch: a child process inherits
    its pytest worker's peak resident size, which
    tests/test_chunked_ingest.py measures (tests/torch_gpu_common.py)."""
    code = ("import sys, pytest; "
            "rc = pytest.main(['--collect-only', '-q', '-p', 'no:cacheprovider', "
            "'tests/']); print('torch' in sys.modules, rc)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "False 0", out.stdout[-2000:]


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """The loader pointed at an empty build directory, nothing loaded."""
    monkeypatch.setattr(N1, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(N1, "_LIB", None)
    return tmp_path / "_build"


FAKE_CXX = """\
import sys
print("fastx.cpp:1: error: no", file=sys.stderr)
sys.exit(3)
"""


def test_failed_build_raises_with_stderr(build_dir, tmp_path, monkeypatch):
    fake = tmp_path / "fake_cxx.py"
    fake.write_text(FAKE_CXX)
    # "g++" is the interpreter running the fake's script
    monkeypatch.setattr(N1, "CXX", sys.executable)
    monkeypatch.setattr(N1, "FLAGS", [str(fake), *N1.FLAGS])
    with pytest.raises(N1.NativeBuildError, match="exit 3") as ei:
        N1.load()
    assert "error: no" in str(ei.value)
    assert not any(build_dir.iterdir())  # no partial library left


def test_missing_compiler_raises(build_dir, monkeypatch):
    monkeypatch.setattr(N1, "CXX", str(build_dir / "no-such-g++"))
    with pytest.raises(N1.NativeBuildError, match="no-such-g"):
        N1.load()


def test_opt_out_returns_none_and_builds_nothing(build_dir, monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    assert N1.load() is None
    assert not build_dir.exists()
    monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "0")
    assert N1.load() is not None  # read on every call, before the cache


def test_library_name_follows_source_and_flags(build_dir, monkeypatch):
    path = N1.library_path()
    assert path.parent == build_dir
    assert re.fullmatch(r"libsmafa_native_[0-9a-f]{16}\.so", path.name)
    monkeypatch.setattr(N1, "FLAGS", [*N1.FLAGS, "-DSMAFA_TEST_FLAG"])
    assert N1.library_path() != path


LOAD_AND_CALL = """\
import pathlib, sys
from smafa_tpu_torch import native
native.BUILD_DIR = pathlib.Path(sys.argv[1])
lib = native.load()
print(lib.tsv_format_bound(1, 3), native.library_path().name)
"""


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Two processes building into one empty directory at once: each
    loads and calls a whole library, and only that library is left."""
    build_dir = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", LOAD_AND_CALL,
                               str(build_dir)], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    bound, name = lines.pop().split()
    assert int(bound) > 0
    assert [p.name for p in build_dir.iterdir()] == [name]
