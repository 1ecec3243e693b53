"""The port's cluster engine on the CPU against smafa_tpu's: seeded fuzz
inputs with heavy promotion, invariance to batch size, the adaptive
batch schedule and pipeline depth, the batch re-chunker, and the
centroid store built from the same codes (the state carried across).
Exact equality throughout. At most 21 tests (see test_torch_cluster.py)."""

from __future__ import annotations

import io

import numpy as np
import pytest

import smafa_tpu.engine.cluster as C0

LETTERS = np.frombuffer(b"ACGTN", np.uint8)


def write_fasta(path, codes: np.ndarray) -> str:
    with open(path, "w") as f:
        for i, row in enumerate(LETTERS[codes]):
            f.write(f">s{i}\n{row.tobytes().decode()}\n")
    return str(path)


def port_cluster(path, max_div, **kw) -> str:
    import torch

    from smafa_tpu_torch.engine.cluster import cluster

    buf = io.StringIO()
    cluster(path, max_div, torch.device("cpu"), out=buf, **kw)
    return buf.getvalue()


def jax_cluster(path, max_div, **kw) -> str:
    buf = io.StringIO()
    C0.cluster(path, max_div, out=buf, **kw)
    return buf.getvalue()


def _promotion_heavy(seed, n=1500, L=8):
    """tests/test_cluster.py:174's input: a binary alphabet and a run of
    duplicates, so batches promote densely and capture across rows."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 2, size=(n, L)).astype(np.uint8)
    seqs[200:220] = seqs[7]
    return seqs


@pytest.mark.parametrize("maxdiv", [0, 1, 2, 3])
def test_promotion_heavy_matches_jax(tmp_path, maxdiv):
    fa = write_fasta(tmp_path / "hvy.fna", _promotion_heavy(77))
    for bs in (64, 700, None):
        kw = {} if bs is None else {"batch_size": bs}
        want = jax_cluster(fa, maxdiv, **kw)
        assert port_cluster(fa, maxdiv, **kw) == want, bs


@pytest.mark.parametrize("seed", range(6))
def test_cluster_fuzz_matches_jax(tmp_path, seed):
    """tests/test_fuzz_parity.py:148's generator: random widths, a 3-letter
    alphabet plus N, injected duplicates, random batch sizes."""
    rng = np.random.default_rng(200 + seed)
    L = int(rng.integers(3, 20))
    n = int(rng.integers(2, 120))
    seqs = rng.integers(0, 3, (n, L)).astype(np.uint8)
    seqs[rng.random((n, L)) < 0.05] = 4
    for _ in range(n // 4):
        seqs[int(rng.integers(0, n))] = seqs[int(rng.integers(0, n))]
    fa = write_fasta(tmp_path / "in.fna", seqs)
    maxdiv = int(rng.integers(0, max(1, L // 2)))
    bs = int(rng.integers(2, 17))
    assert port_cluster(fa, maxdiv, batch_size=bs) == jax_cluster(
        fa, maxdiv, batch_size=bs)


def test_batch_size_invariance(tmp_path):
    fa = write_fasta(tmp_path / "b.fna", _promotion_heavy(5, n=400, L=10))
    ref = jax_cluster(fa, 2, batch_size=512)
    for bs in (1, 2, 3, 37, 512):
        assert port_cluster(fa, 2, batch_size=bs) == ref, bs


def test_adaptive_batches_identical(tmp_path, monkeypatch):
    # tests/test_cluster.py:49 on the port: growing batches, small cap
    import smafa_tpu_torch.engine.cluster as C1

    rng = np.random.default_rng(7)
    fa = write_fasta(tmp_path / "ad.fna",
                     rng.integers(0, 4, (500, 10)).astype(np.uint8))
    ref = jax_cluster(fa, 3, batch_size=64)
    monkeypatch.setenv("SMAFA_TPU_CLUSTER_BATCH_MAX", "128")
    monkeypatch.setattr(C1, "DEFAULT_BATCH", 16)
    assert port_cluster(fa, 3) == ref
    monkeypatch.setenv("SMAFA_TPU_CLUSTER_BATCH_MAX", "100000")
    assert port_cluster(fa, 3) == ref


def test_pipeline_depth_invariance(tmp_path, monkeypatch):
    fa = write_fasta(tmp_path / "p.fna", _promotion_heavy(9, n=300, L=9))
    ref = jax_cluster(fa, 1, batch_size=8)
    for depth in ("1", "2", "4"):
        monkeypatch.setenv("SMAFA_TPU_CLUSTER_PIPELINE", depth)
        assert port_cluster(fa, 1, batch_size=8) == ref, depth


def _src(widths):
    for k, (n, L) in enumerate(widths):
        ids = [f"s{k}_{j}" for j in range(n)]
        raws = [b"x" * L for _ in range(n)]
        yield ids, raws, np.full((n, L), k % 5, np.uint8)


@pytest.mark.parametrize("widths,start,cap", [
    ([(4, 6)] * 12, 4, 16),
    ([(4, 6), (4, 6), (4, 9)], 4, 64),
    ([(3, 5)] * 7 + [(10, 2)] + [(1, 5)] * 3, 2, 8),
])
def test_grow_batches_matches_jax(widths, start, cap):
    from smafa_tpu_torch.engine.cluster import _grow_batches

    got = list(_grow_batches(_src(widths), start, cap))
    want = list(C0._grow_batches(_src(widths), start, cap))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_array_equal(g[2], w[2])


def test_grow_batches_flushes_before_error():
    from smafa_tpu_torch.engine.cluster import _grow_batches

    def bad():
        yield ["a"], [b"xxxxxx"], np.zeros((1, 6), np.uint8)
        raise ValueError("boom")

    it = _grow_batches(bad(), 8, 8)
    assert next(it)[2].shape == (1, 6)
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.mark.parametrize("n,splits", [(300, [300]), (20000, [20000]),
                                      (20000, [9000, 11000])])
def test_centroid_store_matches_jax(n, splits):
    """The cluster state carried across: both packages' stores built from
    the same centroid codes (the port's in one or several appends, with
    a growth past 16384 rows) give equal (dist, idx) per query row."""
    import torch

    from smafa_tpu_torch.engine.cluster import _CentroidStore

    rng = np.random.default_rng(n + len(splits))
    L = 60
    codes = rng.integers(0, 5, (n, L), dtype=np.uint8)
    codes[n // 3] = codes[n // 7]  # duplicate centroids: lower index wins
    q = rng.integers(0, 5, (40, L), dtype=np.uint8)
    q[:5] = codes[rng.integers(0, n, 5)]
    q[5] = codes[n // 3]
    ref = C0._CentroidStore(L)
    first = min(n, ref.cap)  # smafa_tpu's store cannot grow on its first append
    ref.append(codes[:first])
    if first < n:
        ref.append(codes[first:])
    want = ref.scan_fetch(ref.scan_async(q))
    store = _CentroidStore.from_codes(codes[:splits[0]], torch.device("cpu"))
    for lo, hi in zip(np.cumsum(splits)[:-1], np.cumsum(splits)[1:]):
        store.append(codes[lo:hi])
    assert len(store) == n and store.cap >= n
    got = store.scan_fetch(store.scan_async(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert store.decoded == ref.decoded
