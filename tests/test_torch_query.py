"""End to end on the CPU: smafa_tpu_torch's makedb + best-hit query print
byte for byte what smafa_tpu's print, on the golden data and on a seeded
fuzz db with heavy ties; errors keep their texts and exit codes; the
path not ported yet (multi-host) exits 101 pointing to ROADMAP.md.

The best-hit grid over every golden file is in
test_torch_query_best_hit_{a,b,c}.py, the CLI's usage, device and
import checks in test_torch_query_cli.py; they take their helpers and
the autouse CPU fixture from here."""

from __future__ import annotations

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


def run(capsys, main, *argv):
    code = main(list(argv))
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def both(capsys, *argv):
    """(rc, stdout, last stderr line) of each package on the same argv."""
    out = []
    for main in (main0, main1):
        code, o, e = run(capsys, main, *argv)
        lines = e.strip().splitlines()
        out.append((code, o, lines[-1] if lines else ""))
    return out


def test_golden_dna_makedb_and_query(capsys, tmp_path):
    # reference tests/test_cmdline.rs:10-25, through the port
    t = str(tmp_path / "db")
    assert run(capsys, main1, "makedb", "-i", f"{D}/random_3_2.fna", "-d", t)[0] == 0
    code, out, _ = run(capsys, main1, "query", "-d", t, "-q", f"{D}/random_3_2.fna")
    assert code == 0
    assert out == "0\t0\t0\tCTT\n1\t1\t0\tAGG\n"


def test_golden_makedb_byte_identical_to_reference(capsys, tmp_path):
    t = tmp_path / "db"
    assert run(capsys, main1, "makedb", "-i", f"{D}/random_3_2.fna", "-d", str(t))[0] == 0
    assert t.read_bytes() == open(f"{D}/random_3_2.fna.smafadb", "rb").read()


def test_golden_max_num_hits1(capsys):
    # reference tests/test_cmdline.rs:144-161 (K=1 == best-hit mode)
    code, out, _ = run(capsys, main1, "query", "-d", f"{D}/random_3_2.fna.smafadb",
                       "-q", f"{D}/random_3_2.fna", "--max-num-hits", "1")
    assert code == 0
    assert out == "0\t0\t0\tCTT\n1\t1\t0\tAGG\n"


# The best-hit cases: golden file x flags x db format, 56 in all; the
# tests are in test_torch_query_best_hit_{a,b,c}.py, 21 or fewer a file.
BEST_HIT_CASES = [(fname, extra, fmt) for fname in GOLDEN_FILES
                  for extra in ([], ["--max-divergence", "0"],
                                ["--max-divergence", "1"],
                                ["--max-num-hits", "1", "--max-divergence", "99"])
                  for fmt in ("postcard", "native")]


def check_best_hit(capsys, tmp_path, fname, extra, fmt):
    dbs = []
    for i, main in enumerate((main0, main1)):
        db = str(tmp_path / f"db{i}")
        assert run(capsys, main, "makedb", "-i", f"{D}/{fname}", "-d", db,
                   "--format", fmt)[0] == 0
        dbs.append(db)
    # each package queries the db the OTHER one wrote: shared formats
    r0 = run(capsys, main0, "query", "-d", dbs[1], "-q", f"{D}/{fname}", *extra)
    r1 = run(capsys, main1, "query", "-d", dbs[0], "-q", f"{D}/{fname}", *extra)
    assert r0[0] == r1[0] == 0
    assert r1[1] == r0[1]


def _fuzz_files(tmp_path, seed=0, n=3000, nq=500, L=60):
    """~3,000 x 60 bp db with duplicate groups of 2, 5 and 40, and reads
    drawn from it with 0-6 substitutions."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    codes[rng.random((n, L)) < 0.01] = 4  # some N
    perm = rng.permutation(n)
    used = 0
    for g in (2, 5, 40):
        k = (n // 5 // 3) // g
        pos = perm[used:used + k * g].reshape(k, g)
        used += k * g
        codes[pos[:, 1:]] = codes[pos[:, :1]]
    q = codes[rng.integers(0, n, nq)].copy()
    subs = rng.integers(0, 7, nq)
    for i in range(nq):
        p = rng.choice(L, subs[i], replace=False)
        q[i, p] = (q[i, p] + rng.integers(1, 4, p.size)) % 4
    letters = np.frombuffer(b"ACGTN", np.uint8)
    for name, m in (("db.fna", codes), ("q.fna", q)):
        with open(tmp_path / name, "w") as f:
            for i, row in enumerate(letters[m]):
                f.write(f">{name[0]}{i}\n{row.tobytes().decode()}\n")
    return str(tmp_path / "db.fna"), str(tmp_path / "q.fna")


@pytest.mark.parametrize("maxdiv", [None, 0, 5])
def test_fuzz_matches_jax(capsys, tmp_path, maxdiv):
    db_fa, q_fa = _fuzz_files(tmp_path)
    extra = [] if maxdiv is None else ["--max-divergence", str(maxdiv)]
    outs = []
    for i, main in enumerate((main0, main1)):
        for fmt in ("postcard", "native"):
            db = str(tmp_path / f"db{i}.{fmt}")
            assert run(capsys, main, "makedb", "-i", db_fa, "-d", db,
                       "--format", fmt)[0] == 0
            code, out, _ = run(capsys, main, "query", "-d", db, "-q", q_fa,
                               "--batch-size", "128", *extra)
            assert code == 0
            outs.append(out)
    assert outs[0] and all(o == outs[0] for o in outs[1:])
    # ties: some query prints a whole duplicate group
    if maxdiv is None:
        qnums = [line.split("\t", 1)[0] for line in outs[0].splitlines()]
        assert max(qnums.count(x) for x in set(qnums)) >= 40


def test_fuzz_output_file(capsys, tmp_path):
    db_fa, q_fa = _fuzz_files(tmp_path, seed=1, n=500, nq=50)
    outs = []
    for i, main in enumerate((main0, main1)):
        db, out = str(tmp_path / f"db{i}"), tmp_path / f"out{i}.tsv"
        assert run(capsys, main, "makedb", "-i", db_fa, "-d", db)[0] == 0
        assert run(capsys, main, "query", "-d", db, "-q", q_fa, "-o", str(out))[0] == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("argv", [
    ["query", "-d", f"{D}/random_3_2.fna.v1.smafadb", "-q", f"{D}/random_3_2.fna"],
    ["query", "-d", f"{D}/random_3_2.fna.smafadb", "-q", f"{D}/random_3_2.fna",
     "--limit-per-sequence", "1"],
    ["query", "-d", f"{D}/random_3_2.fna.smafadb", "-q", f"{D}/random_3_2.fna",
     "--max-num-hits", "0"],
    ["query", "-d", f"{D}/random_3_2.fna.smafadb", "-q", f"{D}/degenerate.fna"],
    ["query", "-d", f"{D}/random_3_2.fna.smafadb", "-q", f"{D}/missing.fna"],
    ["query", "-d", f"{D}/missing.smafadb", "-q", f"{D}/random_3_2.fna"],
    ["makedb", "-i", f"{D}/missing.fna", "-d", "unused"],
])
def test_error_texts_match_jax(capsys, argv):
    (c0, o0, e0), (c1, o1, e1) = both(capsys, *argv, "--quiet") \
        if argv[0] == "query" else both(capsys, *argv)
    assert c0 == c1 == 101
    assert (o1, e1) == (o0, e0)


def test_invalid_base_streams_prefix(capsys, tmp_path):
    """Hits of the records before an invalid base print, then exit 101."""
    q = tmp_path / "q.fna"
    q.write_text(">a\nCTT\n>b\nAGG\n>c\nAXG\n")
    (c0, o0, e0), (c1, o1, e1) = both(
        capsys, "query", "-d", f"{D}/random_3_2.fna.smafadb", "-q", str(q),
        "--batch-size", "1", "--quiet")
    assert c0 == c1 == 101 and o0 == o1 == "0\t0\t0\tCTT\n1\t1\t0\tAGG\n"
    assert e1 == e0 and "Byte 88" in e1


def test_empty_db(capsys, tmp_path):
    db = tmp_path / "empty.fna"
    db.write_text("")
    ws = tmp_path / "db"
    from smafa_tpu_torch.core.windowset import WindowSet
    from smafa_tpu_torch.io import postcard

    ws.write_bytes(postcard.dumps(WindowSet(2)))
    (c0, _, e0), (c1, _, e1) = both(capsys, "query", "-d", str(ws), "-q",
                                    f"{D}/random_3_2.fna", "--quiet")
    assert c0 == c1 == 101 and e0 == e1


@pytest.mark.parametrize("argv,what", [
    (["query", "--coordinator", "localhost:1", "--num-processes", "2",
      "--process-id", "0"], "Multi-host"),
])
def test_not_ported_query_paths(capsys, argv, what):
    code, out, err = run(capsys, main1, argv[0], "-d",
                         f"{D}/random_3_2.fna.smafadb", "-q",
                         f"{D}/random_3_2.fna", *argv[1:])
    assert code == 101 and out == ""
    assert what in err and "ROADMAP.md" in err


@pytest.mark.parametrize("argv", [
    ["cluster", "-i", f"{D}/cluster_bug1.fna", "-d", "2", "--coordinator",
     "localhost:1", "--num-processes", "2", "--process-id", "0"]])
def test_not_ported_subcommands(capsys, argv):
    code, out, err = run(capsys, main1, *argv)
    assert code == 101 and out == "" and "ROADMAP.md" in err


def test_help_and_version(capsys):
    code, out, _ = run(capsys, main1)
    assert code == 0 and "makedb" in out and "query" in out
    with pytest.raises(SystemExit) as ei:
        main1(["-V"])
    assert ei.value.code == 0 and capsys.readouterr().out.strip() == "0.1.0"
    with pytest.raises(SystemExit):
        main1(["--help"])
    assert "Ben J. Woodcroft" in capsys.readouterr().out
