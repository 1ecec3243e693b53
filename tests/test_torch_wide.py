"""The wide route through the CLI on the CPU: windows of 2^25 - 1 bp or
more, where not even one 64-row tile packs a 31-bit key, rehearsed at
127 and 300 bp with both packages' key budgets cut in-process to
BUDGET_BITS = 12 bits (neither package has a knob for it): a 64-row
tile needs 6 index bits beside 7 or 9 distance bits. smafa_tpu then
picks ``sharded`` and serves the query with its exact top-M sort-merge
(``ScanRunner.topm``; a spy shows it ran), and the port builds
``parallel.wide.WideRunner``.

The port's stdout equals smafa_tpu's top-M run and smafa_tpu's uncut
run, byte for byte: best-hit with and without --max-divergence, K-mode
at K = 3 and 99 with and without --limit-per-sequence 1, a forced
SMAFA_TPU_LAYOUT=stream and =sharded, the db in slabs (the CPU's
default, and a memory cut with SMAFA_TPU_HBM_BYTES) and resident (a
card's memory given), and a --resume-state run after a crash. The
cluster, two gloo ranks and the route's parts are in
test_torch_wide_more.py."""

from __future__ import annotations

import contextlib
import io

import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from smafa_tpu_torch.utils.testing import CrashError, CrashyFile
from test_torch_query import _fuzz_files
from test_torch_topm_case import LAYOUT_VARS, cut_budget, run

BUDGET_BITS = 12
N_DB = 1200
N_Q = 120


def wide_cut(real):
    """``packing_shift`` that packs only within BUDGET_BITS bits: no
    64-row tile at 127 bp or more."""
    return cut_budget(real, lambda shift, dist_bits:
                      shift + dist_bits <= BUDGET_BITS)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    for var in LAYOUT_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """(db path, reads path) per window length, built by smafa_tpu."""
    out = {}
    for L in (127, 300):
        tmp = tmp_path_factory.mktemp(f"wide{L}")
        db_fa, q_fa = _fuzz_files(tmp, seed=L + 1, n=N_DB, nq=N_Q, L=L)
        db = str(tmp / "db")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main0(["makedb", "-i", db_fa, "-d", db]) == 0
        out[L] = (db, q_fa)
    return out


def topm_reference(capsys, monkeypatch, db, q, *extra):
    """smafa_tpu's stdout with its key budget cut: ScanRunner's top-M
    path serves it (asserted by a spy)."""
    from smafa_tpu.ops import distance as D0
    from smafa_tpu.parallel import select as select0, sharded

    served = []
    real_topm = sharded.ScanRunner.topm
    with monkeypatch.context() as m:
        m.setattr(D0, "packing_shift", wide_cut(D0.packing_shift))
        m.setattr(sharded.ScanRunner, "topm",
                  lambda self, *a, **kw: served.append(1)
                  or real_topm(self, *a, **kw))
        assert select0.choose_layout(N_DB, 127) == "sharded"
        out = run(capsys, main0, "query", "-d", db, "-q", q, *extra)
    assert served, "smafa_tpu's top-M path did not serve the query"
    return out


def cut_port(m):
    """Cut the port's key budget inside the monkeypatch context m."""
    from smafa_tpu_torch.ops import keys as K

    m.setattr(K, "packing_shift", wide_cut(K.packing_shift))


def port(capsys, monkeypatch, db, q, *extra, env=None):
    """The port's stdout with its key budget cut, and the runner built."""
    from smafa_tpu_torch.parallel import select

    made, make = [], select.make_runner
    with monkeypatch.context() as m:
        cut_port(m)
        m.setattr(select, "make_runner",
                  lambda *a: made.append(make(*a)) or made[-1])
        for var, val in (env or {}).items():
            m.setenv(var, val)
        out = run(capsys, main1, "query", "-d", db, "-q", q, *extra)
    return out, made[0]


def check(capsys, monkeypatch, dbs, L, extra, env=None, tier="slabs"):
    from smafa_tpu_torch.parallel.wide import WideRunner

    db, q = dbs[L]
    got, runner = port(capsys, monkeypatch, db, q, *extra, env=env)
    assert type(runner) is WideRunner
    assert runner.tier == tier and runner.shift is None
    assert got == topm_reference(capsys, monkeypatch, db, q, *extra)
    assert got == run(capsys, main0, "query", "-d", db, "-q", q, *extra)
    return got


@pytest.mark.parametrize("L", [127, 300])
@pytest.mark.parametrize("extra", [
    [], ["--max-divergence", "3"],
    ["--max-num-hits", "3"],
    ["--max-num-hits", "3", "--limit-per-sequence", "1"],
    ["--max-num-hits", "99"],
    ["--max-num-hits", "99", "--limit-per-sequence", "1"]],
    ids=["best", "best_div3", "k3", "k3_limit1", "k99", "k99_limit1"])
def test_wide_route_equals_smafa_tpu(capsys, monkeypatch, dbs, L, extra):
    out = check(capsys, monkeypatch, dbs, L, [*extra, "--batch-size", "64"])
    assert out.count("\n") >= N_Q // 2


@pytest.mark.parametrize("layout", ["stream", "sharded"])
def test_forced_layouts_take_the_wide_route(capsys, monkeypatch, dbs,
                                            layout):
    """A forced stream or sharded layout where no tile packs: the wide
    route serves it."""
    check(capsys, monkeypatch, dbs, 300, ["--max-num-hits", "7"],
          env={"SMAFA_TPU_LAYOUT": layout})


@pytest.mark.parametrize("hbm,tier", [(str(1 << 40), "resident"),
                                      (str(1 << 19), "slabs")])
def test_resident_tier_and_memory_cut(capsys, monkeypatch, dbs, hbm, tier):
    """A card's memory that holds the twin keeps it resident; a memory
    cut to 512 KiB sends the db into slabs, here of 256 rows (5 a batch),
    and cuts the query batch by bytes."""
    env = {"SMAFA_TPU_HBM_BYTES": hbm}
    if tier == "slabs":
        env["SMAFA_TPU_SLAB_BYTES"] = str(256 * 127)
    check(capsys, monkeypatch, dbs, 127, ["--max-num-hits", "5"], env=env,
          tier=tier)


def test_slabs_of_the_memory_cut(monkeypatch, dbs):
    """The memory cut's plan: 5 slabs of 256 rows, and query batches of
    32 rows (8 embeddings of 512 bytes a row in the 128 KiB left); a
    block's slabs come through the stream layout's uploads
    (``slab.SlabUploads._upload``), one a slab, in order."""
    import numpy as np
    import torch

    from smafa_tpu_torch.ops import distance as D
    from smafa_tpu_torch.parallel import select
    from smafa_tpu_torch.parallel.slab import SlabUploads
    from smafa_tpu_torch.parallel.wide import WideRunner

    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 19))
    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(256 * 127))
    codes = np.broadcast_to(np.zeros(1, np.uint8), (N_DB, 127))
    r = WideRunner(codes, 127, torch.device("cpu"))
    assert (r.tier, r.slab_rows, r.n_slabs) == ("slabs", 256, 5)
    assert select.fit_batch(127, torch.device("cpu"), 8) == 32
    seen, upload = [], SlabUploads._upload
    monkeypatch.setattr(SlabUploads, "_upload", lambda self, s, off, n: (
        seen.append((s, off, n)) or upload(self, s, off, n)))
    q = D.expand_embed_query(torch.zeros((2, 127), dtype=torch.uint8), 127)
    blk = r._compute(q)
    assert seen == [(s, 256 * s, min(256, N_DB - 256 * s)) for s in range(5)]
    # N against N matches: every distance 0
    assert blk.shape == (2, N_DB) and not blk.any()
    assert r.h2d_bytes == 0  # uploads are counted on a card only


def test_resume_after_crash(capsys, monkeypatch, dbs, tmp_path):
    """A run crashed in its third batch's write and resumed from its
    state equals smafa_tpu's straight run."""
    import torch

    from smafa_tpu_torch.engine.query import query

    db, q = dbs[300]
    want = topm_reference(capsys, monkeypatch, db, q, "--max-num-hits", "4")
    state, out = tmp_path / "st.json", tmp_path / "out.tsv"
    with monkeypatch.context() as m:
        cut_port(m)
        kw = dict(device=torch.device("cpu"), max_num_hits=4, batch_size=16,
                  resume_state=state)
        with open(out, "a+") as f, pytest.raises(CrashError):
            query(db, q, out=CrashyFile(f, fail_at=3), **kw)
        assert 0 < len(out.read_text()) < len(want)
        with open(out, "a+") as f:
            query(db, q, out=f, **kw)
    assert out.read_text() == want
