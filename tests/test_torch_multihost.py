"""Multi-process query through the port's CLI on the CPU: two gloo ranks
(``--coordinator 127.0.0.1:<free port> --num-processes 2``) print, on
rank 0, byte for byte what smafa_tpu's single-process CLI prints, on the
golden files and on a seeded fuzz db with heavy ties (duplicate groups
of 2, 5 and 40, so compactions cross the rank boundary), best-hit and
K-mode with --max-divergence, --max-num-hits and --limit-per-sequence,
and ``cluster`` on cluster_bug1.fna; rank 1 prints nothing.

Every run starts both ranks with a timeout and kills both on failure
(``run_ranks``); the other multi-process files (test_torch_multihost_io.py)
take their helpers from here."""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from smafa_tpu.cli import main as main0
from test_torch_query import GOLDEN_FILES, _fuzz_files

D = "tests/data"
ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 240  # seconds a rank may take before both are killed
WORKER = "import sys\n{preamble}\nfrom smafa_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(*argv, n=2, preamble="", env=None, rank_args=None):
    """The port's CLI as n gloo ranks on the CPU, each with ``argv`` (and
    ``rank_args(rank)`` appended). ``preamble`` is Python run in each rank
    before the CLI (a patch); without one the ranks run ``python -m
    smafa_tpu_torch``. Returns [(rc, stdout, stderr)] in rank order."""
    port = free_port()
    e = dict(os.environ, SMAFA_TPU_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT))
    e.update(env or {})
    head = ([sys.executable, "-c", WORKER.format(preamble=preamble)]
            if preamble else [sys.executable, "-m", "smafa_tpu_torch"])
    procs = []
    try:
        for r in range(n):
            extra = rank_args(r) if rank_args else []
            procs.append(subprocess.Popen(
                [*head, *argv, *extra, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(n), "--process-id", str(r)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=e, cwd=ROOT))
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o, err) for p, (o, err) in zip(procs, outs)]


def last_line(text: str) -> str:
    lines = text.strip().splitlines()
    return lines[-1] if lines else ""


def jax_cli(capsys, *argv):
    """(rc, stdout, last stderr line) of smafa_tpu's CLI in this process."""
    code = main0(list(argv))
    cap = capsys.readouterr()
    return code, cap.out, last_line(cap.err)


def check_ranks(capsys, jax_argv, *argv, **kw):
    """Two ranks of the port against smafa_tpu on one process: rank 0's
    stdout equal, rank 1's empty, both exit 0. Returns the ranks' runs."""
    code, want, err = jax_cli(capsys, *jax_argv)
    assert code == 0, err
    runs = run_ranks(*argv, **kw)
    for rc, _out, e in runs:
        assert rc == 0, e[-3000:]
    assert runs[0][1] == want
    assert runs[1][1] == ""
    return runs


def _query_argv(db, q, *flags):
    return ("query", "-d", db, "-q", q, *flags)


@pytest.mark.parametrize("fname", GOLDEN_FILES)
def test_two_ranks_golden_best_hit(capsys, tmp_path, fname):
    db = str(tmp_path / "db")
    assert jax_cli(capsys, "makedb", "-i", f"{D}/{fname}", "-d", db)[0] == 0
    argv = _query_argv(db, f"{D}/{fname}")
    check_ranks(capsys, argv, *argv)


@pytest.mark.parametrize("flags", [
    ["--max-num-hits", "99", "--limit-per-sequence", "1"],
    ["--max-num-hits", "2", "--max-divergence", "2"],
])
def test_two_ranks_golden_kmode(capsys, flags):
    argv = _query_argv(f"{D}/random_3_2_one_repeated.fna.smafadb",
                       f"{D}/random_3_2.fna", *flags)
    check_ranks(capsys, argv, *argv)


@pytest.fixture
def fuzz(tmp_path, capsys):
    """The seeded fuzz db (3,000 x 60 bp, heavy ties) in the native
    format, and its 500 reads."""
    db_fa, q_fa = _fuzz_files(tmp_path)
    db = str(tmp_path / "db.native")
    assert jax_cli(capsys, "makedb", "-i", db_fa, "-d", db, "--format",
                   "native")[0] == 0
    return db, q_fa


@pytest.mark.parametrize("flags", [
    [], ["--max-divergence", "4"], ["--batch-size", "64"]])
def test_two_ranks_fuzz_best_hit(capsys, fuzz, flags):
    db, q = fuzz
    argv = _query_argv(db, q, "--batch-size", "128", *flags)
    runs = check_ranks(capsys, argv, *argv, "-v")
    # each rank holds one shard: rows [0, 1536) and [1536, 3000)
    assert "holds rows [0, 1536)" in runs[0][2]
    assert "holds rows [1536, 3000)" in runs[1][2]
    if not flags:  # some read prints a whole duplicate group of 40
        qnums = [line.split("\t", 1)[0] for line in runs[0][1].splitlines()]
        assert max(qnums.count(x) for x in set(qnums)) >= 40


@pytest.mark.parametrize("flags", [
    ["--max-num-hits", "99"],
    ["--max-num-hits", "40", "--max-divergence", "4"],
    ["--max-num-hits", "99", "--limit-per-sequence", "1"],
    ["--max-num-hits", "5000"],
])
def test_two_ranks_fuzz_kmode(capsys, fuzz, flags):
    db, q = fuzz
    argv = _query_argv(db, q, "--batch-size", "128", *flags)
    check_ranks(capsys, argv, *argv)


def test_two_ranks_query_split_off(capsys, fuzz):
    """SMAFA_TPU_QUERYSPLIT=0: every rank parses the whole query file."""
    db, q = fuzz
    argv = _query_argv(db, q, "--batch-size", "128")
    runs = check_ranks(capsys, argv, *argv, "-v",
                       env={"SMAFA_TPU_QUERYSPLIT": "0"})
    assert "Query stream split" not in runs[0][2]


# the argv the port refused with exit 101 before it ran multi-process,
# now run as two ranks
@pytest.mark.parametrize("argv", [
    ("query", "-d", f"{D}/random_3_2.fna.smafadb", "-q",
     f"{D}/random_3_2.fna")])
def test_multihost_query_argv(capsys, argv):
    check_ranks(capsys, argv, *argv)


@pytest.mark.parametrize("argv", [
    ("cluster", "-i", f"{D}/cluster_bug1.fna", "-d", "2")])
def test_multihost_cluster_argv(capsys, argv):
    check_ranks(capsys, argv, *argv)


def test_new_modules_load_no_jax():
    """In a fresh interpreter: the multi-process modules (the ring and
    column layouts too) import neither jax nor smafa_tpu."""
    code = ("import sys, smafa_tpu_torch.parallel.multihost, "
            "smafa_tpu_torch.parallel.comm, smafa_tpu_torch.parallel.sharded, "
            "smafa_tpu_torch.parallel.querysplit, "
            "smafa_tpu_torch.parallel.ring, smafa_tpu_torch.parallel.seqpar, "
            "smafa_tpu_torch.utils.profiling, smafa_tpu_torch.ops.hist; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'smafa_tpu')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"
