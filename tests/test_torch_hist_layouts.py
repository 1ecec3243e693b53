"""The K-mode histogram (``SMAFA_TPU_KMODE_HIST=1``) in every layout of
the port with more than one rank, on the CPU. Each runner's ``_hist``
equals ``ScanRunner``'s on the same codes: the stream layout's sum over
slabs, the row shards' sum over ranks (``ShardedRunner``, an empty
shard included), the ring's blocks summed over the shards they hold and
gathered, the column slices' fold over the all-reduced distance blocks
(ranks simulated in threads, tests/test_torch_querysplit.py). Through
the CLI as two gloo ranks (tests/test_torch_multihost.py's
``run_ranks``) under the sharded, ring and col layouts, rank 0 prints
smafa_tpu's single-process bytes under the same switch."""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from test_torch_multihost import check_ranks
from test_torch_query import _fuzz_files, run
from test_torch_querysplit import run_ranks
from test_torch_ring import make_db

SWITCH = "SMAFA_TPU_KMODE_HIST"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv(SWITCH, "1")
    for var in ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
                "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES"):
        monkeypatch.delenv(var, raising=False)


def _want(codes, q, L):
    """ScanRunner's histogram of the batch (padded as the runner pads
    it), and the runner."""
    import torch

    from smafa_tpu_torch.parallel.runner import ScanRunner

    r = ScanRunner(codes, L, torch.device("cpu"))
    q_emb = r._embed_queries(r._pad(q)[0])
    return r._hist(q_emb).numpy(), r


@pytest.mark.parametrize("layout", ["sharded", "ring", "col"])
@pytest.mark.parametrize("n", [2, 3])
def test_rank_hist_equals_scan_runner(monkeypatch, layout, n):
    """1,000 rows with duplicate groups across the shard edges and 121
    reads: every rank's histogram of the whole batch equals the single
    device's. 3 ranks of 1,000 rows at 150 bp for the col layout (its
    slices cut the 608-byte embedding)."""
    import torch

    from smafa_tpu_torch.parallel import ring, seqpar, sharded

    L = 150 if layout == "col" else 60
    codes, q = make_db(seed=n, n=1000, nq=121, L=L)
    if layout == "col":
        monkeypatch.setattr(seqpar, "BLOCK_BYTES", 128 * 64 * 4)
    cls = {"sharded": sharded.ShardedRunner, "ring": ring.RingRunner,
           "col": seqpar.ColumnShardedRunner}[layout]

    def work(comm):
        r = cls(codes, L, torch.device("cpu"), comm=comm)
        q_pad = r._pad(q)[0]
        return q_pad.shape[0], r._hist(r._embed_queries(q_pad)).numpy()

    res, errs = run_ranks(n, work)
    assert errs == [None] * n, errs
    want, _ = _want(codes, q, L)
    for b, got in res:
        np.testing.assert_array_equal(got[:121], want[:121])
        assert got.shape == (b, L + 1)
        assert (got[:121].sum(axis=1) == 1000).all()


def test_sharded_empty_shard_and_stream(monkeypatch):
    """4 ranks over 130 rows hold 64, 64, 2 and no rows; the stream
    layout in 3 slabs of 64 rows, resident and streaming."""
    import torch

    from smafa_tpu_torch.parallel import sharded, slab

    codes, q = make_db(seed=9, n=130, nq=20)
    want, _ = _want(codes, q, 60)

    def work(comm):
        r = sharded.ShardedRunner(codes, 60, torch.device("cpu"), comm=comm)
        return r.n_local, r._hist(r._embed_queries(r._pad(q)[0])).numpy()

    res, errs = run_ranks(4, work)
    assert errs == [None] * 4, errs
    assert [n for n, _ in res] == [64, 64, 2, 0]
    for _, got in res:
        np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(64 * 60))
    for resident in ("1", "0"):
        monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT", resident)
        r = slab.SlabStreamRunner(codes, 60, torch.device("cpu"))
        assert r.n_slabs == 3
        got = r._hist(r._embed_queries(r._pad(q)[0])).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["sharded", "ring", "col"])
@pytest.mark.parametrize("extra", [
    ["--max-num-hits", "99"],
    ["--max-num-hits", "40", "--max-divergence", "4",
     "--limit-per-sequence", "2"]])
def test_two_ranks_kmode_with_switch(capsys, tmp_path, layout, extra):
    """Two gloo ranks under the layout and the switch, the query split
    on: rank 0 prints smafa_tpu's single-process bytes under the switch,
    and each rank logs its layout."""
    db_fa, q_fa = _fuzz_files(tmp_path, seed=6, nq=300)
    db = str(tmp_path / "db")
    assert run(capsys, main0, "makedb", "-i", db_fa, "-d", db)[0] == 0
    argv = ("query", "-d", db, "-q", q_fa, "--batch-size", "128", *extra)
    env = {SWITCH: "1"}
    if layout != "sharded":
        env["SMAFA_TPU_LAYOUT"] = layout
    runs = check_ranks(capsys, argv, *argv, "-v", env=env)
    assert runs[0][1].count("\n") > 250
    for rank, (_rc, _out, err) in enumerate(runs):
        assert f"{layout} layout: rank {rank} of 2" in err
