"""The column-sharded layout (``smafa_tpu_torch.parallel.seqpar``), ranks
simulated in threads over ``ThreadComm`` (tests/test_torch_querysplit.py):
every hit mode equals smafa_tpu's ``ColumnShardedScanRunner`` on
conftest's 8-device CPU mesh (``build_col_mesh(n)``) exactly, at 1, 2
and 3 ranks and L = 10, 24, 150 and 300 (past 127 an int8 product would
wrap on the CPU), with chunks of 64 db rows (a cut block budget) so
the folds cross chunks; also with an empty last column slice, rows
enumerated on the host, a one-rank ``LocalComm``, and past a cut key
budget (tests/test_layouts.py:464); and the auto rule that takes col at
long windows over several processes. All on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_querysplit import run_ranks
from test_torch_ring import assert_same, make_db, modes


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    for var in ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
                "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def mods(monkeypatch):
    import types

    import torch

    from smafa_tpu.parallel import seqpar as S0
    from smafa_tpu_torch.ops import distance, keys
    from smafa_tpu_torch.parallel import hitops, seqpar
    from smafa_tpu_torch.parallel.comm import LocalComm
    from smafa_tpu_torch.parallel.runner import ScanRunner

    # blocks of 2 KiB a batch row: chunks of 64 db rows at 32 reads
    monkeypatch.setattr(seqpar, "BLOCK_BYTES", 32 * 64 * 4)
    return types.SimpleNamespace(torch=torch, cpu=torch.device("cpu"),
                                 C=seqpar, S0=S0, D=distance, H=hitops,
                                 K=keys, LocalComm=LocalComm,
                                 ScanRunner=ScanRunner)


def col_ranks(mods, codes, q, n, L):
    """Each simulated rank's (modes(runner, q), runner)."""
    def work(comm):
        r = mods.C.ColumnShardedRunner(codes, L, mods.cpu, comm=comm)
        return modes(r, q), r

    res, errs = run_ranks(n, work)
    assert errs == [None] * n, errs
    return res


@pytest.mark.parametrize("L", [10, 24, 150, 300])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_col_equals_smafa_tpu(mods, n, L):
    codes, q = make_db(seed=L, n=400, nq=40, L=L)
    want = modes(mods.S0.ColumnShardedScanRunner(
        codes, L, mesh=mods.S0.build_col_mesh(n)), q)
    assert_same(modes(mods.ScanRunner(codes, L, mods.cpu), q), want)
    res = col_ranks(mods, codes, q, n, L)
    ep = mods.D.embed_width(L)
    assert res[0][1].c0 == 0 and res[-1][1].c1 == ep
    for k, (got, r) in enumerate(res):
        assert_same(got, want)
        # each rank holds its column slice of every row
        assert r.db_emb.shape == (448, r.c1 - r.c0)
        assert k == 0 or r.c0 == res[k - 1][1].c1


def test_column_slices(mods):
    """Whole 32-byte groups, the last slice empty where the groups run
    out: L = 10 embeds in 64 bytes, 3 ranks take 32, 32 and none."""
    assert [mods.C.column_slice(10, r, 3) for r in range(3)] == [
        (0, 32), (32, 64), (64, 64)]
    assert [mods.C.column_slice(300, r, 2) for r in range(2)] == [
        (0, 608), (608, 1216)]
    for L in (1, 10, 60, 151, 29903):
        for size in (1, 2, 3, 5):
            sl = [mods.C.column_slice(L, r, size) for r in range(size)]
            assert sl[0][0] == 0 and sl[-1][1] == mods.D.embed_width(L)
            assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
            assert all(c0 % 32 == 0 and c1 >= c0 for c0, c1 in sl)


def test_col_empty_last_slice(mods):
    """L = 10 over 3 ranks: the last rank holds no column and still takes
    part in every sum."""
    codes, q = make_db(seed=5, n=300, nq=33, L=10)
    want = modes(mods.ScanRunner(codes, 10, mods.cpu), q)
    res = col_ranks(mods, codes, q, 3, 10)
    assert res[2][1].db_emb.shape[1] == 0
    for got, _r in res:
        assert_same(got, want)


def test_col_local_comm_and_host_rows(mods, monkeypatch):
    """A forced col in a single process (one rank, one whole slice), and
    rows with more hits than one compaction takes, enumerated on the
    host."""
    codes, q = make_db(seed=6, n=500, nq=50)
    want = modes(mods.ScanRunner(codes, 60, mods.cpu), q)
    r = mods.C.ColumnShardedRunner(codes, 60, mods.cpu, comm=mods.LocalComm())
    assert (r.c0, r.c1) == (0, mods.D.embed_width(60))
    assert_same(modes(r, q), want)
    monkeypatch.setattr(mods.H, "COMPACT_MAX", 8)
    for got, _r in col_ranks(mods, codes, q, 2, 60):
        assert_same(got, want)


@pytest.mark.parametrize("size,L,env,card_ranks,layout", [
    (2, 8192, {}, 1, "col"), (2, 8191, {}, 1, "sharded"),
    (1, 29903, {}, 1, "sharded"),
    (3, 150, {"SMAFA_TPU_COL_SEQ_THRESHOLD": "150"}, 1, "col"),
    (2, 29903, {"SMAFA_TPU_HBM_BYTES": str(1 << 30)}, 1, "sharded"),
    (2, 29903, {"SMAFA_TPU_HBM_BYTES": str(5 * 10**9)}, 1, "col"),
    (2, 29903, {"SMAFA_TPU_HBM_BYTES": str(5 * 10**9)}, 2, "sharded")])
def test_col_auto_rule(mods, monkeypatch, size, L, env, card_ranks, layout):
    """Over more than one process, windows of SMAFA_TPU_COL_SEQ_THRESHOLD
    (8192) bp or more take col, as in smafa_tpu, while the col ranks on
    a card fit 0.75 of it: 32,768 rows of 29,903 bp take 3.03 GB a rank
    of 2 (1.96 GB of column slice and zc, 1 GiB of match blocks), so a
    5 GB card holds one such rank and not two; else the row shards. A
    rank's own shard keeps the one-device rule."""
    import types

    from smafa_tpu_torch.parallel import multihost, select

    monkeypatch.setattr(mods.C, "BLOCK_BYTES", 1 << 27)  # the shipped size
    assert select.col_bytes(32768, 29903, 2) == (
        32768 * (59808 + 4) + 8 * (1 << 27))
    monkeypatch.setattr(multihost, "_COMM", types.SimpleNamespace(
        rank=0, size=size, card_ranks=card_ranks))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert select.choose_layout(32768, L, mods.cpu) == layout
    shard = select.choose_layout(32768, L, mods.cpu, one_device=True)
    monkeypatch.setattr(multihost, "_COMM", None)
    assert shard == select.choose_layout(32768, L, mods.cpu)


def test_col_pair_mode_beyond_key_budget(mods, monkeypatch):
    """tests/test_layouts.py:464's db with keys cut so that only 64 rows
    pack, in both packages: smafa_tpu's column sweep folds pair carries;
    the port's always does, and equals it and the unpatched one-device
    runner."""
    from smafa_tpu.ops import distance as D0

    rng = np.random.default_rng(47)
    L = 10
    pool = rng.integers(0, 5, size=(4, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 4, 300)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(12, L))
                        .astype(np.uint8)])
    oracle = modes(mods.ScanRunner(codes, L, mods.cpu), q)

    def cut(real):
        return lambda seq_len, wp: None if wp > 64 else real(seq_len, wp)

    monkeypatch.setattr(D0, "packing_shift", cut(D0.packing_shift))
    monkeypatch.setattr(mods.K, "packing_shift", cut(mods.K.packing_shift))
    cr = mods.S0.ColumnShardedScanRunner(codes, L,
                                         mesh=mods.S0.build_col_mesh(8),
                                         chunk=16)
    assert cr._min2_pairs
    assert_same(modes(cr, q), oracle)
    for got, _r in col_ranks(mods, codes, q, 3, L):
        assert_same(got, oracle)
