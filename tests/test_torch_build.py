"""The kernel build (smafa_tpu_torch.ops._build) without nvcc: one
compile per source started together, then one link; failures name each
failed command; the library's name follows every source and header; no
object or partial library is left behind."""

from __future__ import annotations

import sys

import pytest

from smafa_tpu_torch.ops import _build

FAKE_NVCC = """\
import sys
args = sys.argv[1:]
if any(a.endswith("bad.cu") for a in args):
    print("bad.cu(1): error: no")
    sys.exit(2)
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write(" ".join(args))
"""


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// a\n")
    (src / "b.cu").write_text("// b\n")
    (src / "tile.cuh").write_text("// shared\n")
    fake = tmp_path / "fake_nvcc.py"
    fake.write_text(FAKE_NVCC)
    # "nvcc" is the interpreter running the fake's script
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
    for flags in ("COMPILE_FLAGS", "LINK_FLAGS"):
        monkeypatch.setattr(_build, flags, [str(fake), *getattr(_build, flags)])
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_build_compiles_each_source_then_links(csrc):
    out = _build.build()
    assert out == _build.library_path() and out.exists()
    link = out.read_text().split()
    assert "-shared" in link and sum(a.endswith(".o") for a in link) == 2
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    assert _build.build() == out  # cached by hash


def test_build_failure_names_the_source(csrc):
    (csrc / "bad.cu").write_text("// bad\n")
    with pytest.raises(_build.KernelBuildError, match="bad.cu") as ei:
        _build.build()
    assert "exit 2" in str(ei.value) and "error: no" in str(ei.value)
    assert not any(_build.BUILD_DIR.iterdir())


def test_library_name_follows_headers(csrc):
    before = _build.library_path()
    (csrc / "tile.cuh").write_text("// shared, changed\n")
    assert _build.library_path() != before
