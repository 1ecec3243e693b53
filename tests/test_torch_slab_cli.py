"""The port's query under the stream layout, through its CLI on the CPU,
against smafa_tpu's CLI on the same files, byte for byte: the golden
files and the seeded heavy-tie fuzz db (duplicate groups of 2, 5 and 40
across ~12 slabs), best-hit and K-mode with --max-divergence and
--limit-per-sequence, both tiers, a crashed and resumed run, and one run
of ``python -m smafa_tpu_torch`` in a subprocess. With the key budget cut
to 16 bits in the port (patched here, in-process; the package has no knob
for it) a 5,000-row db no longer packs global keys, and the automatic
layout choice serves it by streaming. ring and col exit 101.

smafa_tpu runs with its default layout, the port under
SMAFA_TPU_LAYOUT=stream unless a test says otherwise."""

from __future__ import annotations

import math
import os
import pathlib
import subprocess
import sys

import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from test_torch_kmode import jax_runner_per_db  # noqa: F401 (fixture)
from test_torch_query import GOLDEN_FILES, _fuzz_files

D = "tests/data"
LAYOUT_VARS = ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
               "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES")
# 256 rows of 60 bp a slab: the fuzz db's 3,000 rows take 12 slabs
FUZZ_SLAB_BYTES = str(256 * 60)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    for var in LAYOUT_VARS:
        monkeypatch.delenv(var, raising=False)


def run(capsys, main, *argv):
    code = main(list(argv))
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def reference(capsys, monkeypatch, db, q, *extra):
    """smafa_tpu's stdout, in its default layout."""
    with monkeypatch.context() as m:
        for var in LAYOUT_VARS:
            m.delenv(var, raising=False)
        code, out, err = run(capsys, main0, "query", "-d", db, "-q", q, *extra)
    assert code == 0, err
    return out


def streamed(capsys, monkeypatch, db, q, *extra, slab_bytes="64",
             resident="0"):
    """The port's stdout under SMAFA_TPU_LAYOUT=stream."""
    with monkeypatch.context() as m:
        m.setenv("SMAFA_TPU_LAYOUT", "stream")
        m.setenv("SMAFA_TPU_SLAB_BYTES", slab_bytes)
        m.setenv("SMAFA_TPU_SLAB_RESIDENT", resident)
        code, out, err = run(capsys, main1, "query", "-d", db, "-q", q,
                             *extra)
    assert code == 0, err
    return out


def _makedb(capsys, tmp_path, fasta):
    db = str(tmp_path / "db")
    assert run(capsys, main0, "makedb", "-i", fasta, "-d", db)[0] == 0
    return db


@pytest.mark.parametrize("fname", GOLDEN_FILES)
def test_golden_stream(capsys, tmp_path, monkeypatch, jax_runner_per_db,
                       fname):
    db = _makedb(capsys, tmp_path, f"{D}/{fname}")
    q = f"{D}/{fname}"
    for extra in ([], ["--max-divergence", "1"], ["--max-num-hits", "99"],
                  ["--max-num-hits", "3", "--limit-per-sequence", "1"]):
        want = reference(capsys, monkeypatch, db, q, *extra)
        assert streamed(capsys, monkeypatch, db, q, *extra) == want


@pytest.mark.parametrize("extra", [
    [], ["--max-divergence", "5"], ["--max-num-hits", "25"],
    ["--max-num-hits", "99", "--max-divergence", "5",
     "--limit-per-sequence", "1"]])
def test_fuzz_stream_both_tiers(capsys, tmp_path, monkeypatch,
                                jax_runner_per_db, extra):
    db_fa, q_fa = _fuzz_files(tmp_path, seed=len(extra), nq=300)
    db = _makedb(capsys, tmp_path, db_fa)
    extra = [*extra, "--batch-size", "128"]
    want = reference(capsys, monkeypatch, db, q_fa, *extra)
    assert want.count("\n") > 200
    for resident in ("1", "0"):
        assert streamed(capsys, monkeypatch, db, q_fa, *extra,
                        slab_bytes=FUZZ_SLAB_BYTES, resident=resident) == want


def test_resume_under_stream(capsys, tmp_path, monkeypatch):
    """Crashed in its third batch, resumed through the CLI: the bytes of
    smafa_tpu's straight run."""
    import json

    import torch

    from smafa_tpu_torch.engine.query import query
    from smafa_tpu_torch.utils.testing import CrashError, CrashyFile

    db_fa, q_fa = _fuzz_files(tmp_path, seed=7, nq=100)
    db = _makedb(capsys, tmp_path, db_fa)
    extra = ["--max-num-hits", "9", "--batch-size", "16"]
    want = reference(capsys, monkeypatch, db, q_fa, *extra)
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", "stream")
    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", FUZZ_SLAB_BYTES)
    state, outp = tmp_path / "st.json", tmp_path / "o.tsv"
    with open(outp, "w") as f:
        with pytest.raises(CrashError):
            query(db, q_fa, torch.device("cpu"), max_num_hits=9,
                  out=CrashyFile(f, fail_at=3), batch_size=16,
                  resume_state=state)
    assert json.loads(state.read_text())["done"] == 32
    argv = ["query", "-d", db, "-q", q_fa, *extra, "-o", str(outp),
            "--resume-state", str(state), "--quiet"]
    assert main1(argv) == 0
    assert outp.read_text() == want


@pytest.mark.parametrize("extra", [[], ["--max-num-hits", "40",
                                        "--max-divergence", "8"]])
def test_reduced_key_budget_picks_stream(capsys, tmp_path, monkeypatch,
                                         extra):
    """Keys cut to 16 bits: at 60 bp a span of 1,024 rows packs, 5,000
    rows do not, so the resident runner would refuse the db and the
    automatic choice streams it in slabs of 1,024 rows."""
    from smafa_tpu_torch.ops import keys as K
    from smafa_tpu_torch.parallel import select, slab

    db_fa, q_fa = _fuzz_files(tmp_path, seed=11, n=5000, nq=200)
    db = _makedb(capsys, tmp_path, db_fa)
    want = reference(capsys, monkeypatch, db, q_fa, *extra)
    real = K.packing_shift

    def budget16(seq_len, wp):
        shift = real(seq_len, wp)
        dist_bits = math.ceil(math.log2(seq_len + 2))
        fits = shift is not None and shift + dist_bits <= 16
        return shift if fits else None

    monkeypatch.setattr(K, "packing_shift", budget16)
    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(1024 * 60))
    made, make = [], select.make_runner
    monkeypatch.setattr(select, "make_runner",
                        lambda *a: made.append(make(*a)) or made[-1])
    assert run(capsys, main1, "query", "-d", db, "-q", q_fa, *extra)[1] == want
    assert type(made[0]) is slab.SlabStreamRunner
    assert (made[0].slab_rows, made[0].n_slabs) == (1024, 5)


def test_cli_subprocess_stream(capsys, tmp_path, monkeypatch,
                               jax_runner_per_db):
    """``python -m smafa_tpu_torch query`` in a fresh interpreter, the
    layout and slab size from its environment."""
    db_fa, q_fa = _fuzz_files(tmp_path, seed=13, nq=150)
    db = _makedb(capsys, tmp_path, db_fa)
    extra = ["--max-num-hits", "5", "--limit-per-sequence", "2"]
    want = reference(capsys, monkeypatch, db, q_fa, *extra)
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "SMAFA_TPU_TORCH_DEVICE": "cpu",
           "SMAFA_TPU_LAYOUT": "stream",
           "SMAFA_TPU_SLAB_BYTES": FUZZ_SLAB_BYTES, "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-m", "smafa_tpu_torch", "query",
                          "-d", db, "-q", q_fa, *extra, "--verbose"],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want
    assert "db layout: stream" in out.stderr
    assert "12 slabs of 256 rows" in out.stderr


@pytest.mark.parametrize("layout", ["ring", "col", "diagonal"])
def test_forced_layout_cli(capsys, monkeypatch, layout):
    """ring and col, which exited 101 before they were ported, print
    smafa_tpu's bytes under the same layout; a value neither package
    knows fails in both with exit 101 and the same message."""
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", layout)
    argv = ["query", "-d", f"{D}/random_3_2.fna.smafadb", "-q",
            f"{D}/random_3_2.fna"]
    code, out, err = run(capsys, main1, *argv)
    code0, out0, err0 = run(capsys, main0, *argv)
    if layout == "diagonal":
        assert code == code0 == 101 and out == ""
        assert err.strip().splitlines()[-1] == err0.strip().splitlines()[-1]
    else:
        assert code == code0 == 0, err
        assert out == out0 == "0\t0\t0\tCTT\n1\t1\t0\tAGG\n"
