"""Multi-process runs of the port's CLI on the CPU (two gloo ranks)
against smafa_tpu's single-process CLI, byte for byte: the query split
of FASTA and FASTQ files and the replicated parse of gzip; an invalid
base in rank 1's byte range and a length mismatch (the stdout prefix,
the error text on both ranks, exit 101); a rank that fails alone; the
sharded centroid scan of ``cluster`` across growth of its buffer;
query and cluster crashed and resumed mid-stream; and the pair merge of
shards that pack their keys alone where the global keys do not (the
key budget cut in each rank by a patch of
``smafa_tpu_torch.ops.keys.packing_shift``, as tests/test_layouts.py
cuts smafa_tpu's)."""

from __future__ import annotations

import gzip

import numpy as np
import pytest

from smafa_tpu_torch.cli import main as main1
from test_torch_multihost import (D, check_ranks, jax_cli, last_line,
                                  run_ranks)
from test_torch_query import _fuzz_files


@pytest.fixture
def fuzz(tmp_path, capsys):
    db_fa, q_fa = _fuzz_files(tmp_path, seed=3, n=2000, nq=400)
    db = str(tmp_path / "db.native")
    assert jax_cli(capsys, "makedb", "-i", db_fa, "-d", db, "--format",
                   "native")[0] == 0
    return db, q_fa


def _fastq(q_fa: str, path, gz: bool = False) -> str:
    """The reads of ``q_fa`` as FASTQ, every other quality line starting
    with '@' (a false record start for the split to reject)."""
    lines = open(q_fa).read().splitlines()
    out = []
    for i in range(0, len(lines), 2):
        seq = lines[i + 1]
        out += ["@" + lines[i][1:], seq, "+", ("@" if i % 4 else "I") * len(seq)]
    text = "\n".join(out) + "\n"
    path = str(path)
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        open(path, "w").write(text)
    return path


@pytest.mark.parametrize("kind", ["fastq", "fastq.gz"])
def test_fastq_split_and_gzip(capsys, tmp_path, fuzz, kind):
    db, q_fa = fuzz
    q = _fastq(q_fa, tmp_path / f"q.{kind}", gz=kind.endswith("gz"))
    argv = ("query", "-d", db, "-q", q, "--batch-size", "64")
    runs = check_ranks(capsys, argv, *argv, "-v")
    split = "Query stream split across 2 processes" in runs[0][2]
    assert split == (kind == "fastq")  # gzip keeps the replicated parse


def test_invalid_base_in_rank1_range(capsys, tmp_path, fuzz):
    db, q_fa = fuzz
    lines = open(q_fa).read().splitlines()
    bad = 2 * 300 + 1  # record 300 of 400: the second byte range
    lines[bad] = lines[bad][:10] + "X" + lines[bad][11:]
    q = tmp_path / "bad.fna"
    q.write_text("\n".join(lines) + "\n")
    argv = ("query", "-d", db, "-q", str(q), "--batch-size", "64")
    code, want, err = jax_cli(capsys, *argv)
    assert code == 101 and "Byte 88" in err and want
    runs = run_ranks(*argv)
    assert [r[0] for r in runs] == [101, 101]
    assert runs[0][1] == want and runs[1][1] == ""
    assert [last_line(r[2]) for r in runs] == [err, err]


def test_length_mismatch_both_ranks(capsys):
    argv = ("query", "-d", f"{D}/random_3_2.fna.smafadb", "-q",
            f"{D}/degenerate.fna")
    code, want, err = jax_cli(capsys, *argv)
    assert code == 101
    runs = run_ranks(*argv)
    assert [(r[0], r[1], last_line(r[2])) for r in runs] == [
        (101, want, err), (101, "", err)]


# rank 1 fails in its first merge; rank 0, waiting in that collective,
# must fail too (not hang)
FAIL_RANK1 = """
if sys.argv[sys.argv.index("--process-id") + 1] == "1":
    from smafa_tpu_torch.parallel import sharded
    def _fail(self, q_emb):
        raise RuntimeError("rank 1 failed")
    sharded.ShardedRunner._local_pairs = _fail
"""


def test_rank_failing_alone_fails_both():
    runs = run_ranks("query", "-d", f"{D}/random_3_2.fna.smafadb", "-q",
                     f"{D}/random_3_2.fna", preamble=FAIL_RANK1)
    assert [r[0] for r in runs] == [101, 101]
    assert last_line(runs[1][2]) == "rank 1 failed"
    assert runs[0][1] == ""


def _cluster_input(tmp_path, seed=0, n=1500, L=60) -> str:
    """Records mutated off 300 seeds (0-8 substitutions), shuffled, with
    exact duplicates: a few hundred clusters at -d 5."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 4, (300, L), dtype=np.uint8)
    rec = seeds[rng.integers(0, 300, n)].copy()
    for i in range(n):
        p = rng.choice(L, rng.integers(0, 9), replace=False)
        rec[i, p] = (rec[i, p] + rng.integers(1, 4, p.size)) % 4
    rec[rng.integers(0, n, n // 20)] = rec[:n // 20]
    letters = np.frombuffer(b"ACGT", np.uint8)
    path = tmp_path / "clu.fna"
    with open(path, "w") as f:
        for i, row in enumerate(letters[rec]):
            f.write(f">c{i}\n{row.tobytes().decode()}\n")
    return str(path)


# a 64-row initial buffer: shards of 64 rows that grow, and centroids on
# both ranks
SMALL_BUFFER = """
from smafa_tpu_torch.engine import cluster
cluster.INITIAL_CAPACITY = 64
"""


@pytest.mark.parametrize("div,bs", [(5, None), (3, "100")])
def test_cluster_sharded_buffer(capsys, tmp_path, div, bs):
    inp = _cluster_input(tmp_path)
    argv = ["cluster", "-i", inp, "-d", str(div)]
    if bs:
        argv += ["--batch-size", bs]
    runs = check_ranks(capsys, argv, *argv, preamble=SMALL_BUFFER)
    assert len({line.split("\t")[1] for line in runs[0][1].splitlines()}) > 128


def _crash_after(target: str, calls: int) -> str:
    """Preamble: ``target`` (module:function) raises on its call
    ``calls + 1``, in every rank."""
    mod, fn = target.split(":")
    return f"""
import importlib
_m = importlib.import_module("{mod}")
_real, _n = _m.{fn}, [0]
def _crash(*a, **k):
    _n[0] += 1
    if _n[0] > {calls}:
        raise RuntimeError("crash")
    return _real(*a, **k)
_m.{fn} = _crash
"""


def test_query_resume_mid_stream(capsys, tmp_path, fuzz):
    """Both ranks crash after 2 batches, then resume from process 0's
    state (rank 1 is given a state file that does not exist): the output
    file equals smafa_tpu's straight run."""
    db, q_fa = fuzz
    flags = ("--batch-size", "64", "--max-num-hits", "7")
    code, want, _ = jax_cli(capsys, "query", "-d", db, "-q", q_fa, *flags)
    assert code == 0
    out, st = tmp_path / "hits.tsv", tmp_path / "st.json"
    argv = ("query", "-d", db, "-q", q_fa, *flags, "-o", str(out))

    def rank_args(r):
        return ["--resume-state", str(st if r == 0 else tmp_path / "r1.json")]

    runs = run_ranks(*argv, preamble=_crash_after(
        "smafa_tpu_torch.engine.query:_drain_batch", 2), rank_args=rank_args)
    assert [r[0] for r in runs] == [101, 101]
    assert 0 < len(out.read_text()) < len(want)
    runs = run_ranks(*argv, rank_args=rank_args)
    assert [r[0] for r in runs] == [0, 0]
    assert out.read_text() == want
    assert not (tmp_path / "r1.json").exists()


def test_cluster_resume_mid_stream(capsys, tmp_path):
    inp = _cluster_input(tmp_path, seed=1)
    code, want, _ = jax_cli(capsys, "cluster", "-i", inp, "-d", "5",
                            "--batch-size", "200")
    assert code == 0
    out, st = tmp_path / "clu.tsv", tmp_path / "st.json"
    argv = ("cluster", "-i", inp, "-d", "5", "--batch-size", "200", "-o",
            str(out), "--resume-state", str(st))
    runs = run_ranks(*argv, preamble=SMALL_BUFFER + _crash_after(
        "smafa_tpu_torch.engine.cluster:_resolve_emit", 3))
    assert [r[0] for r in runs] == [101, 101]
    assert 0 < len(out.read_text()) < len(want)
    runs = run_ranks(*argv, preamble=SMALL_BUFFER)
    assert [r[0] for r in runs] == [0, 0]
    assert out.read_text() == want


# 17 bits for (dist << shift) | index: at 60 bp (6 distance bits) the
# fuzz db's 2,000 rows do not pack global keys with the layout rule's
# headroom (2 x 2,000 rows need 12 index bits), but each 1,024-row
# shard does
CUT_BUDGET = """
import math
from smafa_tpu_torch.ops import keys
_real = keys.packing_shift
def _cut(seq_len, wp):
    shift = _real(seq_len, wp)
    if shift is None or shift + max(1, math.ceil(math.log2(seq_len + 2))) > 17:
        return None
    return shift
keys.packing_shift = _cut
"""


@pytest.mark.parametrize("flags", [[], ["--max-num-hits", "99"]])
def test_pair_merge_past_key_budget(capsys, fuzz, flags):
    db, q = fuzz
    argv = ("query", "-d", db, "-q", q, "--batch-size", "128", *flags)
    runs = check_ranks(capsys, argv, *argv, "-v", preamble=CUT_BUDGET)
    for rc, _o, err in runs:
        assert "in the ScanRunner layout" in err


def test_num_processes_needs_coordinator(capsys, monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    code = main1(["query", "-d", f"{D}/random_3_2.fna.smafadb", "-q",
                  f"{D}/random_3_2.fna", "--num-processes", "2",
                  "--process-id", "0"])
    cap = capsys.readouterr()
    assert code == 101 and cap.out == ""
    assert "--coordinator" in last_line(cap.err)
