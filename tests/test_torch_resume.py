"""The port's resumable query and cluster streams, mirroring
tests/test_resume.py on the CPU device: a checkpoint and a restart equal
one straight run, which equals smafa_tpu's. Also a cluster resume whose
centroid sidecar holds more than 16,384 rows (one first append past the
store's initial capacity), and both resumes through the CLI."""

import io
import json

import numpy as np
import pytest

from smafa_tpu.engine import cluster as C0, query as Q0
from smafa_tpu_torch.core.alphabet import BYTE_LUT
from smafa_tpu_torch.core.windowset import WindowSet
from smafa_tpu_torch.io import postcard
from smafa_tpu_torch.utils.testing import CrashError, CrashyFile

# The port's engines are imported when a test runs: collecting must not
# load torch (tests/torch_gpu_common.py says why).


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")


def query(*a, **kw):
    import torch
    from smafa_tpu_torch.engine.query import query as run

    return run(*a, device=torch.device("cpu"), **kw)


def _cluster(inp, max_div, **kw):
    import torch
    from smafa_tpu_torch.engine.cluster import cluster

    return cluster(inp, max_div, torch.device("cpu"), **kw)


def query_error():
    from smafa_tpu_torch.engine.query import QueryError

    return QueryError


def _setup(tmp_path, n_db=20, n_q=23, L=12, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: "".join("ACGT"[c] for c in rng.integers(0, 4, L))
    db = [mk() for _ in range(n_db)]
    qs = [mk() for _ in range(n_q)]
    ws = WindowSet(version=2)
    for s in db:
        ws.push(BYTE_LUT[np.frombuffer(s.encode(), np.uint8)])
    dbp = tmp_path / "db"
    dbp.write_bytes(postcard.dumps(ws))
    qf = tmp_path / "q.fna"
    qf.write_text("".join(f">q{i}\n{s}\n" for i, s in enumerate(qs)))
    return dbp, qf


def test_resume_continues_where_left_off(tmp_path):
    dbp, qf = _setup(tmp_path)
    full = io.StringIO()
    query(dbp, qf, out=full, batch_size=5)
    want = io.StringIO()
    Q0.query(dbp, qf, out=want, batch_size=5)
    assert full.getvalue() == want.getvalue()

    state = tmp_path / "state.json"
    part1 = io.StringIO()
    query(dbp, qf, out=part1, batch_size=5, resume_state=state)
    # Simulate a crash after 10 queries: rewrite the state to a mid-run
    # value and replay only the surviving output prefix.
    data = json.loads(state.read_text())
    assert data["done"] == 23
    state.write_text(json.dumps({"query_fasta": str(qf), "done": 10}))
    kept_lines = [l for l in part1.getvalue().splitlines() if int(l.split("\t")[0]) < 10]

    part2 = io.StringIO()
    query(dbp, qf, out=part2, batch_size=5, resume_state=state)
    resumed = "".join(line + "\n" for line in kept_lines) + part2.getvalue()
    assert resumed == full.getvalue()
    assert json.loads(state.read_text())["done"] == 23


def test_resume_exactly_once_with_seekable_output(tmp_path):
    # Crash between output flush and state rename leaves a torn batch in
    # the file; resuming with a seekable output must truncate it away so
    # the final file equals one straight run (no duplicate lines).
    dbp, qf = _setup(tmp_path)
    full_out = tmp_path / "full.tsv"
    with open(full_out, "w") as f:
        query(dbp, qf, out=f, batch_size=5)

    state = tmp_path / "state.json"
    part = tmp_path / "part.tsv"
    with open(part, "w") as f:
        query(dbp, qf, out=f, batch_size=5, resume_state=state)
    # Simulate: state says 10 done, but the file also contains the start
    # of batch 3 (a torn write past the recorded offset).
    data = json.loads(state.read_text())
    lines = part.read_text().splitlines(keepends=True)
    keep = [l for l in lines if int(l.split("\t")[0]) < 10]
    torn = keep + [l for l in lines if int(l.split("\t")[0]) in (10, 11)]
    part.write_text("".join(torn))
    state.write_text(json.dumps({
        "query_fasta": str(qf), "done": 10,
        "out_pos": len("".join(keep)),
    }))
    with open(part, "a") as f:
        query(dbp, qf, out=f, batch_size=5, resume_state=state)
    assert part.read_text() == full_out.read_text()


def test_resume_rejects_different_query_file(tmp_path):
    dbp, qf = _setup(tmp_path)
    state = tmp_path / "state.json"
    state.write_text(json.dumps({"query_fasta": "/elsewhere/q.fna", "done": 5}))
    with pytest.raises(query_error(), match="Resume state"):
        query(dbp, qf, out=io.StringIO(), resume_state=state)


def test_resume_noop_when_complete(tmp_path):
    dbp, qf = _setup(tmp_path)
    state = tmp_path / "state.json"
    out1 = io.StringIO()
    query(dbp, qf, out=out1, batch_size=7, resume_state=state)
    out2 = io.StringIO()
    query(dbp, qf, out=out2, batch_size=7, resume_state=state)
    assert out2.getvalue() == ""


def test_resume_truncates_torn_prefix_before_first_checkpoint(tmp_path):
    # Crash mid-batch-0: the output ends with a torn partial line and the
    # only checkpoint is the done=0 baseline written at startup. Resuming
    # must truncate the torn prefix back to the baseline — while
    # preserving content that predates the run (a user's '>>' append).
    dbp, qf = _setup(tmp_path)
    full_out = tmp_path / "full.tsv"
    with open(full_out, "w") as f:
        query(dbp, qf, out=f, batch_size=5)

    preexisting = "old-results-line\t0\tkeepme\n"
    part = tmp_path / "part.tsv"
    part.write_text(preexisting)
    state = tmp_path / "state.json"

    with open(part, "a+") as f:
        with pytest.raises(CrashError):
            query(dbp, qf, out=CrashyFile(f, fail_at=1), batch_size=5,
                  resume_state=state)
    data = json.loads(state.read_text())
    assert data["done"] == 0
    assert data["out_pos"] == len(preexisting)
    assert part.read_text() != preexisting  # torn fragment really landed

    with open(part, "a+") as f:
        query(dbp, qf, out=f, batch_size=5, resume_state=state)
    assert part.read_text() == preexisting + full_out.read_text()


def test_fresh_run_records_baseline_not_truncating(tmp_path):
    # A fresh resume-state run against a file already holding earlier
    # results must keep them (no truncate-to-zero) and complete normally.
    dbp, qf = _setup(tmp_path)
    full = io.StringIO()
    query(dbp, qf, out=full, batch_size=5)

    prior = "earlier-run-line\n"
    outp = tmp_path / "out.tsv"
    outp.write_text(prior)
    state = tmp_path / "state.json"
    with open(outp, "a+") as f:
        query(dbp, qf, out=f, batch_size=5, resume_state=state)
    assert outp.read_text() == prior + full.getvalue()


def _cluster_setup(tmp_path, n=60, L=14, seed=3):
    rng = np.random.default_rng(seed)
    anc = [''.join("ACGT"[c] for c in rng.integers(0, 4, L)) for _ in range(6)]

    def mut(s):
        s = list(s)
        for _ in range(int(rng.integers(0, 3))):
            s[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        return ''.join(s)

    seqs = [mut(anc[int(rng.integers(0, 6))]) for _ in range(n)]
    # plant exact duplicates spanning the stream so the rebuilt dedup set
    # matters: a dup after the crash point must still be skipped
    seqs[n - 3] = seqs[2]
    seqs[n - 1] = seqs[5]
    f = tmp_path / "in.fna"
    f.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return f


def test_cluster_resume_crash_replay(tmp_path):
    inp = _cluster_setup(tmp_path)
    full = tmp_path / "full.tsv"
    with open(full, "w") as f:
        _cluster(inp, 3, out=f, batch_size=7)
    want = io.StringIO()
    C0.cluster(inp, 3, out=want, batch_size=7)
    assert full.read_text() == want.getvalue()

    state = tmp_path / "cst.json"
    outp = tmp_path / "part.tsv"
    prior = "pre-existing\tline\n"
    outp.write_text(prior)

    with open(outp, "a+") as f:
        with pytest.raises(CrashError):
            _cluster(inp, 3, out=CrashyFile(f, fail_at=4), batch_size=7,
                    resume_state=state)
    data = json.loads(state.read_text())
    assert 0 < data["done"] < 60
    assert (tmp_path / "cst.json.centroids.npy").exists()

    with open(outp, "a+") as f:
        _cluster(inp, 3, out=f, batch_size=7, resume_state=state)
    assert outp.read_text() == prior + full.read_text()
    assert json.loads(state.read_text())["done"] == 60


def test_cluster_resume_noop_when_complete(tmp_path):
    inp = _cluster_setup(tmp_path, seed=4)
    state = tmp_path / "cst.json"
    out1 = io.StringIO()
    _cluster(inp, 3, out=out1, batch_size=9, resume_state=state)
    out2 = io.StringIO()
    _cluster(inp, 3, out=out2, batch_size=9, resume_state=state)
    assert out2.getvalue() == ""


def test_cluster_resume_rejects_different_input(tmp_path):
    inp = _cluster_setup(tmp_path, seed=5)
    state = tmp_path / "cst.json"
    state.write_text(json.dumps({"input_fasta": "/elsewhere/x.fna", "done": 5}))
    with pytest.raises(Exception, match="Resume state"):
        _cluster(inp, 3, out=io.StringIO(), resume_state=state)


def test_cluster_resume_batch_size_change(tmp_path):
    # done is a record count, not a batch count: resuming with a
    # different batch size must still be byte-identical.
    inp = _cluster_setup(tmp_path, seed=6)
    full = io.StringIO()
    _cluster(inp, 3, out=full, batch_size=8)

    state = tmp_path / "cst.json"
    outp = tmp_path / "o.tsv"

    with open(outp, "w+") as f:
        with pytest.raises(CrashError):
            _cluster(inp, 3, out=CrashyFile(f, fail_at=3, torn=False),
                    batch_size=8, resume_state=state)
    with open(outp, "a+") as f:
        _cluster(inp, 3, out=f, batch_size=5, resume_state=state)
    assert outp.read_text() == full.getvalue()


def test_resume_rejects_changed_options(tmp_path):
    # A prefix emitted under one flag set and a suffix under another is
    # not a valid output for either; changed options must error loudly.
    dbp, qf = _setup(tmp_path)
    state = tmp_path / "state.json"
    query(dbp, qf, out=io.StringIO(), batch_size=5, resume_state=state,
          max_num_hits=3)
    with pytest.raises(query_error(), match="different options"):
        query(dbp, qf, out=io.StringIO(), batch_size=5, resume_state=state,
              max_num_hits=7)
    # K=1 is the same mode as K=None (lib.rs:224): equivalent invocations
    # resume each other.
    state2 = tmp_path / "state2.json"
    query(dbp, qf, out=io.StringIO(), batch_size=5, resume_state=state2)
    query(dbp, qf, out=io.StringIO(), batch_size=5, resume_state=state2,
          max_num_hits=1)


def test_cluster_resume_rejects_changed_divergence(tmp_path):
    inp = _cluster_setup(tmp_path, seed=9)
    state = tmp_path / "cst.json"
    _cluster(inp, 3, out=io.StringIO(), batch_size=9, resume_state=state)
    with pytest.raises(Exception, match="different options"):
        _cluster(inp, 6, out=io.StringIO(), batch_size=9, resume_state=state)


def test_cluster_resume_sidecar_past_initial_capacity(tmp_path):
    """More than 16,384 centroids in the sidecar: the resumed store takes
    them in one append past its initial capacity (smafa_tpu's store
    cannot, ROADMAP.md queue 3)."""
    n, L = 20000, 16
    rng = np.random.default_rng(11)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, L))]
    inp = tmp_path / "in.fna"
    inp.write_text("".join(f">r{i}\n{s.tobytes().decode()}\n"
                           for i, s in enumerate(seqs)))
    full = io.StringIO()
    _cluster(inp, 0, out=full, batch_size=4100)

    state = tmp_path / "cst.json"
    outp = tmp_path / "o.tsv"
    with open(outp, "w+") as f:
        with pytest.raises(CrashError):
            _cluster(inp, 0, out=CrashyFile(f, fail_at=5), batch_size=4100,
                     resume_state=state)
    data = json.loads(state.read_text())
    from smafa_tpu_torch.engine.cluster import INITIAL_CAPACITY

    assert data["done"] == 4 * 4100 == data["n_centroids"] > INITIAL_CAPACITY
    side = np.load(tmp_path / "cst.json.centroids.npy")
    assert side.shape == (data["n_centroids"], L)
    with open(outp, "a+") as f:
        _cluster(inp, 0, out=f, batch_size=4100, resume_state=state)
    assert outp.read_text() == full.getvalue()


def test_query_resume_through_cli(tmp_path, capsys):
    """A crashed engine run, resumed by the CLI on the same output file:
    the bytes of smafa_tpu's straight run."""
    from smafa_tpu.cli import main as main0
    from smafa_tpu_torch.cli import main as main1

    dbp, qf = _setup(tmp_path, n_db=40, n_q=31)
    want = tmp_path / "want.tsv"
    assert main0(["query", "-d", str(dbp), "-q", str(qf), "--batch-size", "4",
                  "-o", str(want), "--quiet"]) == 0
    state, outp = tmp_path / "st.json", tmp_path / "o.tsv"
    with open(outp, "w") as f:
        with pytest.raises(CrashError):
            query(dbp, qf, out=CrashyFile(f, fail_at=3), batch_size=4,
                  resume_state=state)
    assert json.loads(state.read_text())["done"] == 8
    argv = ["query", "-d", str(dbp), "-q", str(qf), "--batch-size", "4",
            "-o", str(outp), "--resume-state", str(state), "--quiet"]
    assert main1(argv) == 0
    assert outp.read_bytes() == want.read_bytes()
    assert main1(argv) == 0  # complete: a rerun adds nothing
    assert outp.read_bytes() == want.read_bytes()


def test_cluster_resume_through_cli(tmp_path, capsys):
    from smafa_tpu.cli import main as main0
    from smafa_tpu_torch.cli import main as main1

    inp = _cluster_setup(tmp_path, n=90, seed=12)
    want = tmp_path / "want.tsv"
    assert main0(["cluster", "-i", str(inp), "-d", "2", "--batch-size", "8",
                  "-o", str(want), "--quiet"]) == 0
    state, outp = tmp_path / "st.json", tmp_path / "o.tsv"
    with open(outp, "w") as f:
        with pytest.raises(CrashError):
            _cluster(inp, 2, out=CrashyFile(f, fail_at=6), batch_size=8,
                     resume_state=state)
    assert 0 < json.loads(state.read_text())["done"] < 90
    assert main1(["cluster", "-i", str(inp), "-d", "2", "--batch-size", "5",
                  "-o", str(outp), "--resume-state", str(state),
                  "--quiet"]) == 0
    assert outp.read_bytes() == want.read_bytes()
