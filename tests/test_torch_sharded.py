"""The row-sharded layout (``smafa_tpu_torch.parallel.sharded``) and the
sharded centroid store of ``cluster``, with ranks simulated in threads
over ``ThreadComm`` (tests/test_torch_querysplit.py): every hit mode
equals the one-device ``ScanRunner`` exactly, at 1, 2 and 3 ranks, on a
db with duplicate groups across the rank edges, with shards served by
``ScanRunner`` or the stream layout, empty shards, and rows enumerated
on the host; each rank holds only its own rows on its device. The
centroid store's scans equal the one-device store's across growth of
its buffer. All on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_querysplit import run_ranks

L = 60


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    for var in ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
                "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def mods():
    import types

    import torch

    from smafa_tpu_torch.engine import cluster
    from smafa_tpu_torch.ops import distance, min2, min_count
    from smafa_tpu_torch.parallel import hitops, sharded
    from smafa_tpu_torch.parallel.runner import ScanRunner

    return types.SimpleNamespace(torch=torch, cpu=torch.device("cpu"),
                                 S=sharded, ScanRunner=ScanRunner, H=hitops,
                                 D=distance, CL=cluster, M=min2,
                                 MC=min_count)


def _db(seed=0, n=1000, nq=120):
    """n x 60 bp codes with duplicate groups of 5 and 40 placed across
    the 64-row tile edges and the 2- and 3-rank shard edges, and reads
    off them with 0-6 substitutions (the first reads exact copies)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    for start, g in ((510, 5), (320, 40), (680, 40), (100, 5)):
        codes[start:start + g] = codes[start]
    src = rng.integers(0, n, nq)
    src[:4] = (510, 320, 680, 100)
    q = codes[src].copy()
    for i in range(4, nq):
        p = rng.choice(L, rng.integers(0, 7), replace=False)
        q[i, p] = (q[i, p] + rng.integers(1, 4, p.size)) % 4
    return codes, q


def _modes(runner, q):
    """Every hit mode's result, flat: best-hit at no and at a divergence
    limit, K-mode at three K and limits."""
    out = [runner.best_hit(q), runner.best_hit(q, max_divergence=3)]
    for k, md in ((99, None), (7, 4), (2000, None)):
        out.append(runner.kmode_flat(q, k, md))
    return out


def _assert_same(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _sharded(mods, codes, q, n):
    """Each simulated rank's ShardedRunner results and its runner."""
    def fn(comm):
        r = mods.S.ShardedRunner(codes, L, mods.cpu, comm=comm)
        return _modes(r, q), r

    res, errs = run_ranks(n, fn)
    assert errs == [None] * n, errs
    return res


def test_shard_range_covers_whole_tiles(mods):
    for n_windows in (1, 63, 64, 65, 1000, 4096, 100_001):
        for size in (1, 2, 3, 4, 7):
            parts = [mods.S.shard_range(n_windows, r, size)
                     for r in range(size)]
            assert sum(n for _, n in parts) == n_windows
            end = 0
            for off, n in parts:
                assert off == end and n >= 0
                assert off % 64 == 0 or n == 0
                end += n


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_equals_scan_runner(mods, n):
    codes, q = _db()
    want = _modes(mods.ScanRunner(codes, L, mods.cpu), q)
    res = _sharded(mods, codes, q, n)
    for got, r in res:
        _assert_same(got, want)
    # each rank holds only its own rows
    rows = [r.local.db_codes.shape[0] for _, r in res]
    assert rows == [mods.S.shard_range(1000, k, n)[1] for k in range(n)]
    assert all(r.local.db_emb.shape[0] == -(-k // 64) * 64
               for (_, r), k in zip(res, rows))


def test_sharded_stream_shards(mods, monkeypatch):
    """Each rank's shard served by the stream layout (slabs of 128 rows),
    both tiers."""
    codes, q = _db(seed=1)
    want = _modes(mods.ScanRunner(codes, L, mods.cpu), q)
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", "stream")
    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(128 * L))
    for resident in ("1", "0"):
        monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT", resident)
        res = _sharded(mods, codes, q, 2)
        for got, r in res:
            assert type(r.local).__name__ == "SlabStreamRunner"
            assert r.local.n_slabs == 4
            _assert_same(got, want)


def test_sharded_empty_shards(mods):
    """A db of 70 rows over 3 ranks: the last rank holds none."""
    codes, q = _db(n=1000)
    codes = codes[:70]
    want = _modes(mods.ScanRunner(codes, L, mods.cpu), q)
    res = _sharded(mods, codes, q, 3)
    assert [r.local is None for _, r in res] == [False, False, True]
    for got, _r in res:
        _assert_same(got, want)


def test_sharded_host_enumerated_rows(mods, monkeypatch):
    """Rows with more hits than one compaction takes are enumerated on
    the host from the whole host view, on every rank alike."""
    monkeypatch.setattr(mods.H, "COMPACT_MAX", 8)
    codes, q = _db(seed=2)
    want = _modes(mods.ScanRunner(codes, L, mods.cpu), q)
    for got, _r in _sharded(mods, codes, q, 2):
        _assert_same(got, want)


def test_min2_pair_fold_is_the_slab_merge(mods):
    """Folding two decoded carries equals merging the later one's keys."""
    torch, D = mods.torch, mods.D
    codes, q = _db(seed=4)
    codes = codes[:256].copy()
    codes[120:136] = codes[120]  # a tie group across the halves
    q[0] = codes[120]
    from smafa_tpu_torch.ops import keys as K

    q_emb = D.expand_embed_query(torch.from_numpy(q), L)
    halves = []
    for off in (0, 128):
        emb, zc = D.embed_db(torch.from_numpy(codes[off:off + 128]), L, 128)
        halves.append((off, *mods.M.min2(q_emb, emb, zc, L,
                                         K.packing_shift(L, 128),
                                         with_count=True)))
    init = D.min2_pair_init(q.shape[0], mods.cpu)
    merged = init
    for off, lo, hi, cnt in halves:
        merged = D.min2_pair_merge(merged, lo, hi, cnt, off, 128,
                                   K.packing_shift(L, 128), L)
    first = D.min2_pair_merge(init, *halves[0][1:], 0, 128,
                              K.packing_shift(L, 128), L)
    second = D.min2_pair_merge(init, *halves[1][1:], 128, 128,
                               K.packing_shift(L, 128), L)
    folded = D.min2_pair_fold(first, second)
    for a, b in zip(folded, merged):
        assert torch.equal(a, b)


def _store_scans(mods, comm, batches):
    """A centroid store fed ``batches`` in turn: before each append, the
    scan of the next batch (dist, idx) and min_since over the rows of
    the previous append."""
    store = mods.CL._CentroidStore(L, mods.cpu, comm=comm)
    out = []
    prev = 0
    for b in batches:
        h = store.scan_async(b)
        if h.di is not None:
            out.append(store.scan_fetch(h))
            out.append(store.min_since(h, prev, len(store)))
        prev = len(store)
        store.append(b)
    return out, store


def test_sharded_centroid_store(mods, monkeypatch):
    monkeypatch.setattr(mods.CL, "INITIAL_CAPACITY", 64)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 4, (700, L), dtype=np.uint8)
    rows[400:420] = rows[30]  # ties across the growing shards
    batches = [rows[s:s + 100] for s in range(0, 700, 100)]
    want, _ = _store_scans(mods, None, batches)
    res, errs = run_ranks(2, lambda comm: _store_scans(mods, comm, batches))
    assert errs == [None, None], errs
    for got, store in res:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    # the buffer grew to 1,024 rows: 512 a rank, rank 1 holding 188 live
    stores = [s for _, s in res]
    assert [(s.shard_rows, s.off) for s in stores] == [(512, 0), (512, 512)]
    assert all(s.db_emb.shape[0] == 512 for s in stores)
    assert int((stores[1].zc >= 0).sum()) == 700 - 512
