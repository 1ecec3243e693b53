"""The wide route's parts on the CPU (see test_torch_wide.py for the
query through the CLI): the cluster's wide centroid scan and two gloo
ranks under the same cut key budget (BUDGET_BITS = 12, no 64-row tile
packs at 127 or 300 bp), against smafa_tpu's pair carry (``min_scan``;
a spy shows it ran) and its top-M path; the plain version of the
dist_block kernel against smafa_tpu's ``block_distances``; the
exactness of ``distance.dots`` past 2^24 bp, at a real width and with
its column block cut; the route's plans and limits; and a forced
``col`` and ``ring`` there."""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from test_torch_multihost import check_ranks
from test_torch_query import _fuzz_files
from test_torch_topm_case import run
from test_torch_wide import BUDGET_BITS, cut_port, wide_cut

# smafa_tpu_torch.ops.keys.packing_shift cut in a rank, as wide_cut does
CUT = f"""
import math
from smafa_tpu_torch.ops import keys
_real = keys.packing_shift
def _cut(seq_len, wp):
    s = _real(seq_len, wp)
    fits = s is not None and s + math.ceil(math.log2(seq_len + 2)) <= {BUDGET_BITS}
    return s if fits else None
keys.packing_shift = _cut
"""


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    for var in ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
                "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Heavy-tie fuzz records (duplicate groups of 2, 5 and 40, some N)
    and reads per window length, and smafa_tpu's db of them."""
    import contextlib
    import io

    out = {}
    for L in (127, 300):
        tmp = tmp_path_factory.mktemp(f"widemore{L}")
        db_fa, q_fa = _fuzz_files(tmp, seed=L + 2, n=600, nq=80, L=L)
        db = str(tmp / "db")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main0(["makedb", "-i", db_fa, "-d", db]) == 0
        out[L] = (db_fa, db, q_fa)
    return out


def jax_pair_carry(capsys, monkeypatch, *argv):
    """smafa_tpu's cluster stdout with its key budget cut: min_scan's
    (dist, idx) pair carry serves the scans (a spy, in a freshly jitted
    scan program, so no earlier trace is reused)."""
    import jax

    import smafa_tpu.engine.cluster as C0
    from smafa_tpu.ops import distance as D0

    pairs, real_scan = [], D0.min_scan

    def min_scan(q_oh, db_oh, n, seq_len, chunk):
        pairs.append(D0.packing_shift(seq_len, db_oh.shape[0]) is None)
        return real_scan(q_oh, db_oh, n, seq_len, chunk)

    with monkeypatch.context() as m:
        m.setattr(D0, "packing_shift", wide_cut(D0.packing_shift))
        m.setattr(D0, "min_scan", min_scan)
        m.setattr(C0, "_scan_min", jax.jit(
            C0._scan_min.__wrapped__,
            static_argnames=("seq_len", "chunk", "embed")))
        out = run(capsys, main0, *argv)
    assert pairs and all(pairs), "smafa_tpu's pair carry did not serve"
    return out


@pytest.mark.parametrize("L,div,batch", [(127, 2, 37), (300, 5, 64),
                                         (300, 9, 100)])
def test_wide_cluster_equals_smafa_tpu(capsys, monkeypatch, files, L, div,
                                       batch):
    """The wide centroid scan (one dist_block call a scan, no packed
    key) gives smafa_tpu's bytes, cut and uncut, in batches of 37 to 100
    records (every batch past the first scans)."""
    from smafa_tpu_torch.engine import cluster

    inp = files[L][0]
    argv = ["cluster", "-i", inp, "-d", str(div), "--batch-size", str(batch)]
    spans, calls = [], []
    real_scan, real_block = cluster._CentroidStore.scan_async, cluster.dist_block

    def scan_async(self, q_codes):
        spans.append((self.shift, self.span, len(self) > 0))
        return real_scan(self, q_codes)

    with monkeypatch.context() as m:
        cut_port(m)
        m.setattr(cluster._CentroidStore, "scan_async", scan_async)
        m.setattr(cluster, "dist_block",
                  lambda *a: calls.append(1) or real_block(*a))
        got = run(capsys, main1, *argv)
    assert {s[:2] for s in spans} == {(None, None)}
    assert len(calls) == sum(s[2] for s in spans) > 0
    assert got == jax_pair_carry(capsys, monkeypatch, *argv)
    assert got == run(capsys, main0, *argv)


@pytest.mark.parametrize("flags", [["--max-divergence", "4"],
                                   ["--max-num-hits", "9",
                                    "--limit-per-sequence", "1"]])
def test_two_ranks_on_the_wide_route(capsys, files, flags):
    """Two gloo ranks, sharded: each rank's shard takes the wide route,
    the ranks' pair carries and hits merge; rank 0 prints smafa_tpu's
    bytes."""
    _, db, q = files[300]
    argv = ("query", "-d", db, "-q", q, *flags, "--batch-size", "32")
    runs = check_ranks(capsys, argv, *argv, preamble=CUT)
    for r, (_, _, err) in enumerate(runs):
        assert f"rank {r} of 2 holds rows" in err
        assert "in the WideRunner layout" in err


@pytest.mark.parametrize("L,b,w", [(127, 1, 64), (300, 16, 128),
                                   (300, 77, 64 * 3 + 37)])
def test_dist_block_plain_equals_block_distances(L, b, w):
    """dist_block's plain version (the wrapper on CPU tensors) equals
    smafa_tpu's block_distances on the same seeded codes; padding rows
    read L + 1."""
    import jax.numpy as jnp
    import torch

    from smafa_tpu.ops import distance as D0
    from smafa_tpu_torch.ops import distance as D
    from smafa_tpu_torch.ops.dist_block import dist_block

    rng = np.random.default_rng(b + w)
    db = rng.integers(0, 5, (w, L)).astype(np.uint8)
    q = rng.integers(0, 5, (b, L)).astype(np.uint8)
    q[: min(b, 3)] = db[: min(b, 3)]
    wp = -(-w // 64) * 64
    emb, zc = D.embed_db(torch.from_numpy(db), L, wp)
    got = dist_block(D.expand_embed_query(torch.from_numpy(q), L), emb, zc,
                     L).numpy()
    want = np.asarray(D0.block_distances(
        D0.expand_embed_query(jnp.asarray(q), L), jnp.asarray(db),
        jnp.int32(0), w, L))
    np.testing.assert_array_equal(got[:, :w], want)
    assert (got[:, w:] == L + 1).all()
    assert got.dtype == np.int32


def test_dots_exact_past_2_24_bp():
    """One query and two db rows of 2^24 + 3 bp (odd, past float32's
    integers): the exact match reads 0, a row with 5 substitutions and
    N against N reads 5, as numpy counts them."""
    import torch

    from smafa_tpu_torch.ops import distance as D

    L = (1 << 24) + 3
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, L, dtype=np.uint8)
    q[rng.integers(0, L, 7)] = 4  # N matches N (reference lib.rs:80-88)
    db = np.stack([q, q])
    db[1, rng.choice(L, 5, replace=False)] ^= 1
    assert D.embed_width(L) > D.EXACT_COLS
    q_emb = D.expand_embed_query(torch.from_numpy(q[None]), L)
    emb, zc = D.expand_embed_db(torch.from_numpy(db), L)
    got = D.distances(q_emb, emb, zc, L).numpy()
    np.testing.assert_array_equal(got, [[0, 5]])
    np.testing.assert_array_equal(got, (db != q).sum(axis=1)[None])


def test_dots_column_blocks(monkeypatch):
    """The column block cut to 64 columns (16 positions): 300 bp take 19
    blocks, exactly the distances of smafa_tpu's block_distances; below
    the block one product runs. The block is pinned to 2^24 positions,
    the most a float32 sum of -1, 0 and 1 holds exactly."""
    import jax.numpy as jnp
    import torch

    from smafa_tpu.ops import distance as D0
    from smafa_tpu_torch.ops import distance as D

    f32 = np.float32
    assert D.EXACT_COLS == 4 * (1 << 24)
    assert f32(1 << 24) + f32(1) == f32(1 << 24)  # the next integer rounds
    L = 300
    rng = np.random.default_rng(11)
    db = rng.integers(0, 5, (70, L)).astype(np.uint8)
    q = np.concatenate([db[:4], rng.integers(0, 5, (12, L)).astype(np.uint8)])
    q_emb = D.expand_embed_query(torch.from_numpy(q), L)
    emb, zc = D.expand_embed_db(torch.from_numpy(db), L)
    products = []
    real = torch.Tensor.__matmul__
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        lambda a, b: products.append(1) or real(a, b))
    whole = D.distances(q_emb, emb, zc, L)
    assert len(products) == 1
    monkeypatch.setattr(D, "EXACT_COLS", 64)
    blocked = D.distances(q_emb, emb, zc, L)
    assert len(products) == 1 + 19
    want = np.asarray(D0.block_distances(
        D0.expand_embed_query(jnp.asarray(q), L), jnp.asarray(db),
        jnp.int32(0), 70, L))
    np.testing.assert_array_equal(blocked.numpy(), want)
    np.testing.assert_array_equal(whole.numpy(), want)


def test_dist_block_plan_and_limits():
    """K splits fill 4 waves of 3 blocks an SM without passing the K
    chunks; an embedding past the kernel's int32 EP raises, naming the
    limit, before any row is read (meta tensors)."""
    import torch

    from smafa_tpu_torch.ops import dist_block as DB

    ep = DB.MAX_EP + 32
    assert DB.split_k(16, 128, 1 << 27, 132) == 792  # 2 tiles x 792
    assert DB.split_k(16, 128, 1216, 132) == 10      # ceil(1216 / 128)
    assert DB.split_k(4096, 1 << 20, 1 << 27, 132) == 1
    meta = torch.device("meta")
    q = torch.empty((16, ep), dtype=torch.int8, device=meta)
    db = torch.empty((64, ep), dtype=torch.int8, device=meta)
    zc = torch.empty((64,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match=f"limit of {DB.MAX_EP} bytes"):
        DB.dist_block(q, db, zc, ep // 4)


def test_sizes_by_bytes_at_2_25_bp(monkeypatch):
    """On an 80 GB card: at 2^25 bp query batches of 16 reads, cluster
    batches of 8 records and a first store of 64 rows; at 60 bp every
    schedule stays; at 29,903 bp the store's 16,384 rows and every query
    tier up to 16,384 reads stay, and cluster batches stop at 8,192."""
    import torch

    from smafa_tpu_torch.engine import cluster, query
    from smafa_tpu_torch.parallel import select

    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(80 * 10**9))
    cpu = torch.device("cpu")
    L = 1 << 25
    assert select.fit_batch(L, cpu, query.ROW_EMBEDS) == 16
    assert select.fit_batch(L, cpu, cluster.ROW_EMBEDS) == 8
    assert cluster._initial_capacity(L, cpu) == 64
    assert cluster._initial_capacity(700_000, cpu) == cluster.INITIAL_CAPACITY
    assert cluster._initial_capacity(800_000, cpu) == 2048
    for short in (60, 29903):
        assert cluster._initial_capacity(short, cpu) == 16384
    assert select.fit_batch(60, cpu, query.ROW_EMBEDS) >= 65536
    assert select.fit_batch(60, cpu, cluster.ROW_EMBEDS) >= 32768
    assert select.fit_batch(29903, cpu, query.ROW_EMBEDS) == 16384
    assert select.fit_batch(29903, cpu, cluster.ROW_EMBEDS) == 8192
    monkeypatch.delenv("SMAFA_TPU_HBM_BYTES")
    assert select.fit_batch(L, cpu, 8) is None
    assert cluster._initial_capacity(L, cpu) == cluster.INITIAL_CAPACITY


def test_forced_col_runs_on_the_wide_route(monkeypatch):
    """A forced col where no tile packs: the port's col folds (dist,
    index) pairs and packs no key, so it answers, equal to the wide
    runner (smafa_tpu's col raises there)."""
    import torch

    from smafa_tpu_torch.parallel import select
    from smafa_tpu_torch.parallel.seqpar import ColumnShardedRunner
    from smafa_tpu_torch.parallel.wide import WideRunner
    from test_torch_ring import assert_same, modes

    rng = np.random.default_rng(8)
    L = 127
    pool = rng.integers(0, 5, (20, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 20, 300)]
    q = np.concatenate([pool[:6], rng.integers(0, 5, (10, L))
                        .astype(np.uint8)])
    cpu = torch.device("cpu")
    with monkeypatch.context() as m:
        cut_port(m)
        wide = select.make_runner(codes, L, cpu)
        m.setenv("SMAFA_TPU_LAYOUT", "col")
        col = select.make_runner(codes, L, cpu)
        assert type(wide) is WideRunner and type(col) is ColumnShardedRunner
        assert_same(modes(col, q), modes(wide, q))


def test_forced_ring_raises_at_2_25_bp(monkeypatch):
    """A forced ring at 2^25 bp raises KeyPackingError, as smafa_tpu's
    RingScanRunner raises, before any row is read or allocated."""
    import torch

    from smafa_tpu_torch.parallel import select
    from smafa_tpu_torch.parallel.runner import KeyPackingError

    monkeypatch.setenv("SMAFA_TPU_LAYOUT", "ring")
    codes = np.broadcast_to(np.zeros(1, np.uint8), (4, 1 << 25))
    with pytest.raises(KeyPackingError, match="wide route"):
        select.make_runner(codes, 1 << 25, torch.device("cpu"))
