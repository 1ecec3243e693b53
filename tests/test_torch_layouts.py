"""The port's CLI under a forced ``SMAFA_TPU_LAYOUT=ring`` or ``col`` on
the CPU. In one process (one rank, ``comm.LocalComm``) it prints byte for
byte what smafa_tpu's CLI prints under the same layout (on conftest's
8-device mesh), as tests/test_layouts.py:41-100 compares smafa_tpu's
layouts: on the golden files and a seeded heavy-tie fuzz db (duplicate
groups of 2, 5 and 40), best-hit and K-mode with --max-divergence,
--max-num-hits and --limit-per-sequence. As two gloo ranks
(``run_ranks``, tests/test_torch_multihost.py) rank 0 prints what
smafa_tpu's single process prints."""

from __future__ import annotations

import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from test_torch_kmode import jax_runner_per_db  # noqa: F401 (fixture)
from test_torch_multihost import check_ranks
from test_torch_query import GOLDEN_FILES, _fuzz_files, run

D = "tests/data"
LAYOUT_VARS = ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
               "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES")
GOLDEN_FLAGS = ([], ["--max-divergence", "1"], ["--max-num-hits", "99"],
                ["--max-num-hits", "3", "--limit-per-sequence", "1"])
FUZZ_FLAGS = ([], ["--max-divergence", "5"], ["--max-num-hits", "25"],
              ["--max-num-hits", "99", "--max-divergence", "5",
               "--limit-per-sequence", "1"])


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    for var in LAYOUT_VARS:
        monkeypatch.delenv(var, raising=False)


def makedb(capsys, tmp_path, fasta):
    db = str(tmp_path / "db")
    assert run(capsys, main0, "makedb", "-i", fasta, "-d", db)[0] == 0
    return db


def assert_layout_equal(capsys, monkeypatch, layout, db, q, flags):
    """Both packages' stdout under ``layout``, each flag set in turn."""
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", layout)
    lines = 0
    for extra in flags:
        argv = ["query", "-d", db, "-q", q, *extra]
        code0, want, err0 = run(capsys, main0, *argv)
        assert code0 == 0, err0
        code, got, err = run(capsys, main1, *argv, "-v")
        assert code == 0, err
        assert got == want, (layout, extra)
        assert f"db layout: {layout} over 1 processes" in err
        lines += want.count("\n")
    return lines


@pytest.mark.parametrize("layout", ["ring", "col"])
@pytest.mark.parametrize("fname", GOLDEN_FILES)
def test_golden_layouts(capsys, tmp_path, monkeypatch, jax_runner_per_db,
                        fname, layout):
    db = makedb(capsys, tmp_path, f"{D}/{fname}")
    assert assert_layout_equal(capsys, monkeypatch, layout, db,
                               f"{D}/{fname}", GOLDEN_FLAGS) > 0


@pytest.mark.parametrize("layout", ["ring", "col"])
def test_fuzz_layouts(capsys, tmp_path, monkeypatch, jax_runner_per_db,
                      layout):
    db_fa, q_fa = _fuzz_files(tmp_path, seed=3, nq=300)
    db = makedb(capsys, tmp_path, db_fa)
    flags = [[*f, "--batch-size", "128"] for f in FUZZ_FLAGS]
    assert assert_layout_equal(capsys, monkeypatch, layout, db, q_fa,
                               flags) > 1000


@pytest.mark.parametrize("layout,extra", [
    ("ring", ["--max-num-hits", "40", "--limit-per-sequence", "2"]),
    ("col", ["--max-divergence", "4"])])
def test_two_ranks_layouts(capsys, tmp_path, layout, extra):
    """Two gloo ranks under the layout, the query split on: rank 0 prints
    smafa_tpu's single-process bytes."""
    db_fa, q_fa = _fuzz_files(tmp_path, seed=4, nq=300)
    db = makedb(capsys, tmp_path, db_fa)
    argv = ("query", "-d", db, "-q", q_fa, "--batch-size", "128", *extra)
    runs = check_ranks(capsys, argv, *argv, env={"SMAFA_TPU_LAYOUT": layout})
    for rank, (_rc, _out, err) in enumerate(runs):
        assert f"{layout} layout: rank {rank} of 2" in err
