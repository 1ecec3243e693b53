"""The ring layout (``smafa_tpu_torch.parallel.ring``), ranks simulated in
threads over ``ThreadComm`` (tests/test_torch_querysplit.py): every hit
mode equals smafa_tpu's ``RingScanRunner`` on conftest's 8-device CPU
mesh (``build_ring_mesh(n)``) exactly, at 1, 2 and 3 ranks, on a db with
duplicate groups across the shard edges and batches that are no
multiple of the rank count; also with empty shards, rows enumerated on
the host, a one-rank ``LocalComm``, two batches in flight as the query
engine launches them, and past a cut key budget (the pair
mode, tests/test_layouts.py:429). A spy shows one rotation of the held
shard's codes per step, P - 1 a pass, and no gather of a db-shaped
tensor. All on the CPU."""

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

    from smafa_tpu.parallel import ring as R0
    from smafa_tpu_torch.ops import keys
    from smafa_tpu_torch.parallel import hitops, ring, sharded
    from smafa_tpu_torch.parallel.comm import LocalComm
    from smafa_tpu_torch.parallel.runner import KeyPackingError, ScanRunner

    return types.SimpleNamespace(torch=torch, cpu=torch.device("cpu"),
                                 R=ring, R0=R0, H=hitops, K=keys, S=sharded,
                                 LocalComm=LocalComm, ScanRunner=ScanRunner,
                                 KeyPackingError=KeyPackingError)


def make_db(seed=0, n=1000, nq=121, L=L):
    """n x L codes with duplicate groups across the 2- and 3-rank shard
    edges (rows 384, 512 and 768) and a 64-row tile edge, and nq reads
    off them with 0-6 substitutions (the first reads exact copies)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (n, L), dtype=np.uint8)
    groups = [(g, s) for g, s in ((380, 8), (508, 9), (760, 20), (100, 5))
              if g + s <= n]
    for start, g in groups:
        codes[start:start + g] = codes[start]
    src = rng.integers(0, n, nq)
    src[:len(groups)] = [g for g, _ in groups]
    q = codes[src].copy()
    for i in range(len(groups), nq):
        p = rng.choice(L, rng.integers(0, min(7, L)), replace=False)
        q[i, p] = (q[i, p] + rng.integers(1, 5, p.size)) % 5
    return codes, q


def modes(runner, q):
    """Every hit mode's result, flat: best-hit at no and at a divergence
    limit, K-mode at three K and limits (``--limit-per-sequence`` filters
    these lists in the engine; tests/test_torch_layouts.py runs it)."""
    out = [runner.best_hit(q), runner.best_hit(q, max_divergence=3)]
    for k, md in ((99, None), (7, 4), (2000, None)):
        out.append(runner.kmode_flat(q, k, md))
    return out


def assert_same(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def ring_ranks(mods, codes, q, n, fn=modes, L=L):
    """Each simulated rank's (fn(runner, q), runner)."""
    def work(comm):
        r = mods.R.RingRunner(codes, L, mods.cpu, comm=comm)
        return fn(r, q), r

    res, errs = run_ranks(n, work)
    assert errs == [None] * n, errs
    return res


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ring_equals_smafa_tpu(mods, n):
    codes, q = make_db()
    want = modes(mods.R0.RingScanRunner(codes, L,
                                        mesh=mods.R0.build_ring_mesh(n)), q)
    assert_same(modes(mods.ScanRunner(codes, L, mods.cpu), q), want)
    res = ring_ranks(mods, codes, q, n)
    for got, r in res:
        assert_same(got, want)
        # each rank holds only its own rows (its codes, zero-padded)
        off, n_local = r.off, r.n_local
        assert r._own.shape == (r.shard_rows, L)
        np.testing.assert_array_equal(r._own[:n_local].numpy(),
                                      codes[off:off + n_local])
        assert not r._own[n_local:].any()
    assert [(r.off, r.n_local) for _, r in res] == [
        mods.S.shard_range(1000, k, n) for k in range(n)]


def test_ring_local_comm(mods):
    """A forced ring in a single process: one rank, no rotation."""
    codes, q = make_db(seed=1)
    r = mods.R.RingRunner(codes, L, mods.cpu, comm=mods.LocalComm())
    assert_same(modes(r, q), modes(mods.ScanRunner(codes, L, mods.cpu), q))
    assert r.rotations == 0 and not r._arriving


@pytest.mark.parametrize("n", [2, 3])
def test_ring_rotates_codes_once_a_step(mods, n):
    """Every pass rotates the held shard's codes P - 1 times on every rank,
    and the gathers carry per-row results only, never db rows."""
    codes, q = make_db(seed=2)
    seen = {"rotate": [], "gather": [], "sweeps": []}

    def fn(r, q):
        comm = r.comm
        rot, gat, gvar = comm.rotate, comm.all_gather, comm.gather_var
        sweep = r._sweep

        def spy_rotate(t):
            seen["rotate"].append((comm.rank, tuple(t.shape), t.dtype))
            return rot(t)

        def spy_gather(t):
            seen["gather"].append(tuple(t.shape))
            return gat(t)

        def spy_var(t):
            seen["gather"].append(tuple(t.shape))
            return gvar(t)

        def spy_sweep(fold):
            seen["sweeps"].append(comm.rank)
            return sweep(fold)

        comm.rotate, comm.all_gather, comm.gather_var = (spy_rotate,
                                                        spy_gather, spy_var)
        r._sweep = spy_sweep
        return modes(r, q)

    res = ring_ranks(mods, codes, q, n, fn=fn)
    shard = res[0][1].shard_rows
    for rank in range(n):
        rots = [s for s in seen["rotate"] if s[0] == rank]
        assert len(rots) == (n - 1) * seen["sweeps"].count(rank)
        assert all(s[1:] == ((shard, L), mods.torch.uint8) for s in rots)
        assert res[rank][1].rotations == len(rots)
        assert res[rank][1].rotate_bytes == len(rots) * shard * L
    # per-row counts [rows], carries [4 or 5, B/P], hit columns [hits, 3
    # or 4]
    assert seen["gather"]
    for s in seen["gather"]:
        assert len(s) == 1 or s[0] in (4, 5) or s[1] in (3, 4), s


def test_ring_batches_in_flight(mods):
    """The query engine's order (``engine.query._scan_stream``) at 3
    ranks: each batch's first pass is launched before the batch before it
    is resolved, in both hit modes; every batch equals the one-device
    runner's result for it."""
    codes, q = make_db(seed=4, nq=200)
    batches = np.array_split(q, 4)
    ref = mods.ScanRunner(codes, L, mods.cpu)
    want = ([ref.best_hit(b) for b in batches]
            + [ref.kmode_flat(b, 99, 5) for b in batches])

    def fn(r, _q):
        out = []
        for launch, finish in (
                (r.min_count_async,
                 lambda b, h: r.best_hit(b, handle=h)),
                (lambda b: r.kmode_stats_async(b, 99, 5),
                 lambda b, h: r.kmode_flat(b, 99, 5, stats_handle=h))):
            pending = None
            for b in [*batches, None]:
                current = None if b is None else (b, launch(b))
                if pending is not None:
                    out.append(finish(*pending))
                pending = current
        return out

    for got, _r in ring_ranks(mods, codes, q, 3, fn=fn):
        assert_same(got, want)


def test_ring_empty_shards(mods):
    """70 rows over 3 ranks: shards of 64 rows, the last rank's empty; a
    batch of 5 reads, padded to 18."""
    codes, q = make_db(n=70, nq=5)
    want = modes(mods.R0.RingScanRunner(codes, L,
                                        mesh=mods.R0.build_ring_mesh(3)), q)
    res = ring_ranks(mods, codes, q, 3)
    assert [r.n_local for _, r in res] == [64, 6, 0]
    for got, _r in res:
        assert_same(got, want)


def test_ring_host_enumerated_rows(mods, monkeypatch):
    """Rows with more hits than one compaction takes are enumerated on
    the host from the whole host view, on every rank alike."""
    monkeypatch.setattr(mods.H, "COMPACT_MAX", 8)
    codes, q = make_db(seed=3)
    want = modes(mods.ScanRunner(codes, L, mods.cpu), q)
    for got, _r in ring_ranks(mods, codes, q, 2):
        assert_same(got, want)


def test_ring_pair_mode_beyond_key_budget(mods, monkeypatch):
    """tests/test_layouts.py:429's db, keys cut so that only 64 rows
    pack, in both packages: smafa_tpu's ring folds pair carries over 8
    devices, the port's over 5 ranks of 64 rows, equal to the unpatched
    one-device runner; at 2 ranks the port's shards of 192 rows do not
    pack, and it raises."""
    from smafa_tpu.ops import distance as D0

    rng = np.random.default_rng(43)
    Ls = 10
    pool = rng.integers(0, 5, size=(4, Ls)).astype(np.uint8)
    codes = pool[rng.integers(0, 4, 300)]
    q = np.concatenate([pool, rng.integers(0, 5, size=(12, Ls))
                        .astype(np.uint8)])
    oracle = modes(mods.ScanRunner(codes, Ls, mods.cpu), q)

    def cut(real):
        return lambda seq_len, wp: None if wp > 64 else real(seq_len, wp)

    monkeypatch.setattr(D0, "packing_shift", cut(D0.packing_shift))
    monkeypatch.setattr(mods.K, "packing_shift", cut(mods.K.packing_shift))
    rr = mods.R0.RingScanRunner(codes, Ls, mesh=mods.R0.build_ring_mesh(8),
                                chunk=16)
    assert rr._min2_pairs
    assert_same(modes(rr, q), oracle)
    res = ring_ranks(mods, codes, q, 5, L=Ls)
    assert res[0][1].shard_rows == 64
    for got, _r in res:
        assert_same(got, oracle)
    _, errs = run_ranks(2, lambda comm: mods.R.RingRunner(
        codes, Ls, mods.cpu, comm=comm))
    assert all(isinstance(e, mods.KeyPackingError) for e in errs)
