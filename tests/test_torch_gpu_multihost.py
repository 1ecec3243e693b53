"""Two ranks of the port's CLI sharing ``cuda:0`` (gloo: NCCL refuses two
ranks on one card) print what the single-process run on the card prints,
byte for byte: best-hit and K-mode queries on a db of 20,000 windows
with duplicate groups across the rank edge (the query split on), and
``cluster`` with a 64-row initial buffer whose shards grow. One rank
with a coordinator, whose device collectives take NCCL, prints the same
too. Each rank launches its kernels on its own shard.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import io
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_gpu_common import cuda  # noqa: F401

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 300
# each rank: the CLI with its kernels' counts printed to stderr at exit
WORKER = """
import sys
{preamble}
from smafa_tpu_torch.cli import main
from smafa_tpu_torch.ops import compact, kstats, min2, min_count
rc = main(sys.argv[1:])
print("launches", min2.launches, compact.launches, kstats.launches,
      min_count.launches, file=sys.stderr)
sys.exit(rc)
"""


def run_ranks(argv, n=2, preamble=""):
    """The CLI on ``argv`` as n ranks on the card: [(rc, stderr, launches
    of min2, compact_mask, kstats, min_count)] in rank order."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SMAFA_TPU_TORCH_DEVICE", None)
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER.format(preamble=preamble),
                 *argv, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(n), "--process-id", str(r), "-v"],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT))
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = []
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
        counts = [line for line in err.splitlines()
                  if line.startswith("launches ")][-1]
        out.append((p.returncode, err, [int(x) for x in counts.split()[1:]]))
    return out


def _write(path, codes, prefix):
    with open(path, "w") as f:
        for i, row in enumerate(np.frombuffer(b"ACGTN", np.uint8)[codes]):
            f.write(f">{prefix}{i}\n{row.tobytes().decode()}\n")


@pytest.fixture
def files(cuda, tmp_path):
    """A native db of 20,000 x 60 bp windows with duplicate groups of 40
    across the rank edge (row 10,048), and 4,000 reads off it."""
    from smafa_tpu_torch.cli import main

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (20000, 60), dtype=np.uint8)
    for start in (10028, 3000, 19950):
        codes[start:start + 40] = codes[start]
    q = codes[rng.integers(0, 20000, 4000)].copy()
    q[:3] = codes[[10028, 3000, 19950]]
    mut = rng.random(q.shape) < 0.05
    q[mut] = (q[mut] + 1) % 4
    q[:3] = codes[[10028, 3000, 19950]]
    db_fa, q_fa = tmp_path / "db.fna", tmp_path / "q.fna"
    _write(db_fa, codes, "s")
    _write(q_fa, q, "r")
    db = str(tmp_path / "db.native")
    assert main(["makedb", "-i", str(db_fa), "-d", db, "--format",
                 "native"]) == 0
    return db, str(q_fa), tmp_path


def _single(argv, out):
    from smafa_tpu_torch.cli import main

    assert main([*argv, "-o", str(out)]) == 0
    return pathlib.Path(out).read_text()


@pytest.mark.parametrize("flags", [
    ["--max-divergence", "5"], ["--max-num-hits", "99"],
    ["--max-num-hits", "7", "--max-divergence", "4",
     "--limit-per-sequence", "1"]])
def test_two_ranks_on_card_equal_single(files, flags):
    db, q, tmp = files
    argv = ["query", "-d", db, "-q", q, "--batch-size", "1024", *flags]
    want = _single(argv, tmp / "single.tsv")
    runs = run_ranks([*argv, "-o", str(tmp / "ranks.tsv")])
    assert (tmp / "ranks.tsv").read_text() == want and want
    key = 0 if flags[0] == "--max-divergence" else 2  # min2 or kstats
    for _rc, err, launches in runs:
        assert launches[key] > 0
        assert "device collectives gloo" in err
        assert "Query stream split across 2 processes" in err


def test_one_rank_nccl_on_card_equals_single(files):
    db, q, tmp = files
    argv = ["query", "-d", db, "-q", q, "--max-num-hits", "20"]
    want = _single(argv, tmp / "single.tsv")
    ((_rc, err, launches),) = run_ranks(
        [*argv, "-o", str(tmp / "ranks.tsv")], n=1)
    assert (tmp / "ranks.tsv").read_text() == want and want
    assert "device collectives nccl" in err and launches[2] > 0


def test_cluster_two_ranks_on_card_equal_single(cuda, tmp_path):
    rng = np.random.default_rng(3)
    anc = rng.integers(0, 4, (400, 60), dtype=np.uint8)
    rec = anc[rng.integers(0, 400, 6000)]
    k = rng.integers(0, 9, 6000)
    for s in range(8):
        sel = np.nonzero(k > s)[0]
        rec[sel, rng.integers(0, 60, sel.size)] = rng.integers(
            0, 4, sel.size).astype(np.uint8)
    inp = tmp_path / "in.fna"
    _write(inp, rec, "c")
    from smafa_tpu_torch.engine import cluster

    # batches of 500: 12 scans, most of them after centroids exist
    argv = ["cluster", "-i", str(inp), "-d", "4", "--batch-size", "500"]
    buf = io.StringIO()
    cluster.cluster(str(inp), 4, cuda.dev, out=buf, batch_size=500)
    runs = run_ranks([*argv, "-o", str(tmp_path / "ranks.tsv")],
                     preamble="from smafa_tpu_torch.engine import cluster\n"
                              "cluster.INITIAL_CAPACITY = 64")
    got = (tmp_path / "ranks.tsv").read_text()
    assert got == buf.getvalue()
    assert len({line.split("\t")[1] for line in got.splitlines()}) > 128
    assert all(launches[3] > 0 for _rc, _err, launches in runs)
