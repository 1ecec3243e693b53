"""K-mode query end to end on the CPU, through the CLI: the reference's
K-mode goldens, and smafa_tpu_torch printing byte for byte what
smafa_tpu prints on every golden input at K in {2, 5, 99} x
--max-divergence {none, 0, 1, 3} x --limit-per-sequence {none, 1, 2},
each package querying the db the other one wrote, in both formats."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1

D = "tests/data"
GOLDEN_FILES = ["random_3_2.fna", "degenerate.fna",
                "random_3_2_one_repeated.fna", "cluster_best_hit_changes.fna",
                "cluster_bug1.fna", "cluster_dummy1.fna", "subjects.fa"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture
def jax_runner_per_db(monkeypatch):
    """smafa_tpu's CLI builds a runner, and so compiles its programs
    anew, in every query; K and the divergence are traced arguments of
    those programs, so one runner per db (as a long-lived server would
    hold) serves every flag combination of a test with its compiled
    programs."""
    from smafa_tpu.parallel import select

    make = select.make_runner
    runners = {}

    def cached(codes, seq_len):
        key = (np.asarray(codes).tobytes(), tuple(codes.shape), seq_len)
        if key not in runners:
            runners[key] = make(codes, seq_len)
        return runners[key]

    monkeypatch.setattr(select, "make_runner", cached)


def run(capsys, main, *argv):
    code = main(list(argv))
    return code, capsys.readouterr().out


@pytest.mark.parametrize("db,extra,want", [
    # reference tests/test_cmdline.rs:164-181 (K > num windows -> print all)
    ("random_3_2.fna.smafadb", [],
     "0\t0\t0\tCTT\n0\t1\t3\tAGG\n1\t1\t0\tAGG\n1\t0\t3\tCTT\n"),
    # reference tests/test_cmdline.rs:204-224 (repeated subject in db)
    ("random_3_2_one_repeated.fna.smafadb", [],
     "0\t0\t0\tCTT\n0\t1\t3\tAGG\n0\t2\t3\tAGG\n"
     "1\t1\t0\tAGG\n1\t2\t0\tAGG\n1\t0\t3\tCTT\n"),
    # reference tests/test_cmdline.rs:227-247
    ("random_3_2_one_repeated.fna.smafadb", ["--limit-per-sequence", "1"],
     "0\t0\t0\tCTT\n0\t1\t3\tAGG\n1\t1\t0\tAGG\n1\t0\t3\tCTT\n"),
])
def test_kmode_goldens(capsys, db, extra, want):
    """tests/test_cmdline_golden.py:106, :130 and :143 through the port."""
    code, out = run(capsys, main1, "query", "-d", f"{D}/{db}", "-q",
                    f"{D}/random_3_2.fna", "--max-num-hits", "99", *extra)
    assert code == 0 and out == want


@pytest.mark.parametrize("fname", GOLDEN_FILES)
def test_kmode_matches_jax(capsys, tmp_path, jax_runner_per_db, fname):
    dbs = {}
    for i, main in enumerate((main0, main1)):
        for fmt in ("postcard", "native"):
            db = str(tmp_path / f"db{i}.{fmt}")
            assert run(capsys, main, "makedb", "-i", f"{D}/{fname}", "-d", db,
                       "--format", fmt)[0] == 0
            dbs[i, fmt] = db
    combos = itertools.product((2, 5, 99), (None, 0, 1, 3), (None, 1, 2))
    printed = 0
    for n, (k, maxdiv, limit) in enumerate(combos):
        fmt = ("postcard", "native")[n % 2]
        extra = ["--max-num-hits", str(k)]
        if maxdiv is not None:
            extra += ["--max-divergence", str(maxdiv)]
        if limit is not None:
            extra += ["--limit-per-sequence", str(limit)]
        # each package queries the db the OTHER one wrote
        r0 = run(capsys, main0, "query", "-d", dbs[1, fmt], "-q",
                 f"{D}/{fname}", *extra)
        r1 = run(capsys, main1, "query", "-d", dbs[0, fmt], "-q",
                 f"{D}/{fname}", *extra)
        assert r0[0] == r1[0] == 0, extra
        assert r1[1] == r0[1], extra
        printed += len(r1[1])
    assert printed


def test_kmode_flags_above_int32(capsys):
    """--max-num-hits and --max-divergence take any u32 (reference
    main.rs:87-97). smafa_tpu fails on values above 2^31 - 1, converting
    them to int32 on the device (ROADMAP.md queue 3); the port prints
    what both print at K = 99 (above the window count, like 2^32 - 1)
    without a divergence filter (above every distance)."""
    argv = ["query", "-d", f"{D}/random_3_2_one_repeated.fna.smafadb", "-q",
            f"{D}/random_3_2.fna"]
    want = run(capsys, main0, *argv, "--max-num-hits", "99")
    assert want[0] == 0 and want[1]
    for extra in (["--max-num-hits", "4294967295"],
                  ["--max-num-hits", "99", "--max-divergence", "4294967295"]):
        assert run(capsys, main1, *argv, *extra) == want, extra
