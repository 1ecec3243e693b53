"""The min_count kernel (the cluster op's centroid scan) against its
plain PyTorch version on the card: exact equality, with and without the
count, one launch per call that scans, and the route and db splits of
its launch plan.

The short route (L <= 64, "wgmma": csrc/wg_scan.cuh's warp-specialised
tile) at the cluster's batches B = 1, 77, 2048 and 32768 against 29,321
live rows of a 32,768-row buffer (many splits but at 32768 reads, the
last block partial); n_valid = 37 (one partial block), 64 x 47 exactly
and 3001 in a longer buffer whose rows past n_valid are exact copies of
the queries; a db of one repeated row (the counts of every split add up
to n_valid); a db whose only exact match is its last live row; 63 and
64 bp. Then through the library's C entry at 1, 7, the plan's and
ceil(n_valid / 64) splits (the last split owns the partial block at
every count), with and without the count: L = 3, 32, 33, 60, 63 and 64
at B = 1, 77 and 32768, n_valid below 64 and ragged, live rows just past
n_valid that match better; 60 bp at a ragged n_valid 40 times over (the
fastest epilogue, on the shape that would show a zc slot refilled before
it is read); and the cluster's centroid buffer and the stream layout's
slabs, whose zc must be TMA sources. Windows past 64 bp take the
K-chunked route at the plan's splits
(tests/test_torch_gpu_min_count_long.py holds it in depth).

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda  # noqa: F401

pytestmark = pytest.mark.gpu


def _plan(g, b, n_valid, ep):
    return g.M.live_plan(b, n_valid, ep, g.M.sm_count(g.dev),
                         g.M.MIN_COUNT_ITEM_STEPS)


def _embed(g, buf, q, seq_len):
    """(db_emb, zc, q_emb, shift) on the card, the buffer padded to the
    64-row tile."""
    wp = -(-buf.shape[0] // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(buf).to(g.dev), seq_len, wp)
    q_emb = g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev), seq_len)
    return emb, zc, q_emb, g.K.packing_shift(seq_len, wp)


def _scan(g, q_emb, emb, zc, n_valid, seq_len, shift):
    """The kernel's (dist, idx, cnt) as numpy, held exactly to the plain
    version's with the count and without it; one launch per call when
    there is a row to scan."""
    for with_count in (False, True):
        before = g.MC.launches
        got = g.MC.min_count(q_emb, emb, zc, n_valid, seq_len, shift,
                             with_count)
        want = g.D.min_count_reference(q_emb, emb, zc, n_valid, seq_len, shift,
                                       with_count)
        g.torch.cuda.synchronize()
        assert g.MC.launches == before + (n_valid > 0)
        assert len(got) == len(want) == 1 + with_count
        for a, w in zip(got, want):
            assert g.torch.equal(a, w), (n_valid, with_count)
    dist, idx = g.D.unpack_min_key(got[0], shift)
    return dist.cpu().numpy(), idx.cpu().numpy(), got[1].cpu().numpy()


@pytest.mark.parametrize("seq_len", [3, 60, 150, 300])
def test_min_count_kernel_equals_plain(cuda, seq_len):
    """A 5056-row buffer whose every row is live: the scan sees only the
    first n_valid (3001 is not a multiple of the 64-row tile; 0 gives the
    empty-row sentinels and no launch). B = 300 is not a multiple of
    the query block (256 rows); L = 300 streams query and db chunks."""
    torch = cuda.torch
    rng = np.random.default_rng(seq_len)
    wp, b = 5056, 300
    buf = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(0, 3001, 40)] = buf[5]  # ties
    q = buf[rng.integers(0, wp, b)].copy()  # copies of rows past n_valid too
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    q[:4] = buf[5]
    emb, zc = cuda.D.embed_db(torch.from_numpy(buf).to(cuda.dev), seq_len, wp)
    q_emb = cuda.D.expand_embed_query(torch.from_numpy(q).to(cuda.dev), seq_len)
    shift = cuda.K.packing_shift(seq_len, wp)
    for n_valid in (3001, wp, 0):
        for with_count in (True, False):
            before = cuda.MC.launches
            got = cuda.MC.min_count(q_emb, emb, zc, n_valid, seq_len, shift,
                                    with_count)
            want = cuda.D.min_count_reference(q_emb, emb, zc, n_valid, seq_len,
                                              shift, with_count)
            torch.cuda.synchronize()
            assert cuda.MC.launches == before + (n_valid > 0)
            assert len(got) == len(want) == (2 if with_count else 1)
            for a, w in zip(got, want):
                assert torch.equal(a, w), (n_valid, with_count)
            if n_valid == 0:
                assert (got[0] == 2**31 - 1).all()


@pytest.mark.parametrize("b", [1, 77, 2048, 32768])
def test_min_count_split_kernel_equals_plain(cuda, b):
    """The cluster's shapes: 29,321 centroids live in a 32,768-row buffer
    whose rows past them are live too. Every batch but 32768 (128 query
    tiles, one split) takes S > 1 splits and the merge; the last split
    masks the 9-row block; B = 77 leaves most of the query tile past B.
    A tenth of the reads copy a centroid, and centroid 5 has 40 copies,
    ties across the splits."""
    seq_len, wp, n_valid = 60, 32768, 29321
    rng = np.random.default_rng(b)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(6, n_valid, 40)] = buf[5]
    q = buf[rng.integers(0, n_valid, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[: max(1, b // 10)] = buf[5]
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    route, splits = _plan(cuda, b, n_valid, q_emb.shape[1])
    assert route == "wgmma" and (splits > 1) == (b < 32768)
    dist, idx, cnt = _scan(cuda, q_emb, emb, zc, n_valid, seq_len, shift)
    assert dist[0] == 0 and idx[0] == 5 and cnt[0] >= 2


@pytest.mark.parametrize("n_valid", [37, 64 * 47, 3001])
def test_min_count_live_rows_past_n_valid(cuda, n_valid):
    """A 70,016-row buffer scanned to n_valid: past it sit exact copies
    of every query, which would win at distance 0 if they were read, on
    a one-tile db (37), a db of whole tiles (3008) and a partial last
    tile (3001)."""
    seq_len, wp, b = 60, 70016, 300
    rng = np.random.default_rng(n_valid)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    q[:, :2] = (q[:, :2] + 1) % 4  # two substitutions: distance >= 2
    buf[n_valid:n_valid + b] = q
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    assert _plan(cuda, b, n_valid, q_emb.shape[1])[0] == "wgmma"
    dist, idx, cnt = _scan(cuda, q_emb, emb, zc, n_valid, seq_len, shift)
    full = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
    np.testing.assert_array_equal(dist, full.min(axis=1))
    np.testing.assert_array_equal(idx, full.argmin(axis=1))
    np.testing.assert_array_equal(cnt, (full == full.min(axis=1)[:, None]).sum(axis=1))


def test_min_count_repeated_row_db(cuda):
    """A db of one repeated row: every tile of every split ties, so the
    count is n_valid, summed over the splits, and the key's index 0."""
    seq_len, nw, b = 60, 70001, 77
    rng = np.random.default_rng(12)
    buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw, axis=0)
    q = buf[:b].copy()
    q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # distance 0 or 3
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    assert _plan(cuda, b, nw, q_emb.shape[1])[1] > 1
    dist, idx, cnt = _scan(cuda, q_emb, emb, zc, nw, seq_len, shift)
    np.testing.assert_array_equal(dist, (q != buf[0]).sum(axis=1))
    assert (idx == 0).all() and (cnt == nw).all()


def test_min_count_best_match_is_last_live_row(cuda):
    """Half the reads are exact copies of the last live row, the only row
    at distance 0 (in the last split's partial tile), the rest mutated
    copies of it: each must find that row."""
    seq_len, nw, b = 60, 70001, 77
    rng = np.random.default_rng(13)
    buf = rng.integers(0, 4, (nw + 1000, seq_len), dtype=np.uint8)
    q = np.repeat(buf[nw - 1:nw], b, axis=0)
    q[b // 2:, :1] = (q[b // 2:, :1] + 1) % 4
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    dist, idx, cnt = _scan(cuda, q_emb, emb, zc, nw, seq_len, shift)
    assert (dist[: b // 2] == 0).all() and (idx[: b // 2] == nw - 1).all()
    assert (cnt[: b // 2] == 1).all()
    assert (dist[b // 2:] <= 1).all()


def test_min_count_split_route_at_63_and_64_bp(cuda):
    """The widest windows of the short route, where the embedding takes
    its whole 256 bytes; ties planted among the first rows."""
    nw, b = 9000, 300
    for seq_len in (63, 64):
        rng = np.random.default_rng(seq_len)
        buf = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
        buf[rng.integers(8, 8999, 50)] = buf[7]
        q = buf[rng.integers(0, nw, b)].copy()
        q[rng.random(q.shape) < 0.05] = 1
        q[:4] = buf[7]
        emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
        assert _plan(cuda, b, 8999, q_emb.shape[1])[0] == "wgmma"
        dist, idx, cnt = _scan(cuda, q_emb, emb, zc, 8999, seq_len, shift)
        assert (dist[:4] == 0).all() and (idx[:4] == 7).all()
        assert (cnt[:4] >= 2).all()


@pytest.mark.parametrize("seq_len", [150, 300])
def test_min_count_long_route_equals_plain(cuda, seq_len):
    """Windows past 64 bp take the K-chunked wgmma tile (form (a) at 150
    bp, (b) at 300) with ``long_plan``'s splits over the live rows."""
    nw, b = 9000, 77
    rng = np.random.default_rng(seq_len)
    buf = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, nw, b)].copy()
    q[rng.random(q.shape) < 0.05] = 0
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    route, s = _plan(cuda, b, 8999, q_emb.shape[1])
    assert route == ("wg_kchunk" if seq_len <= 160 else "wg_kchunk_stream")
    assert s == cuda.M.long_plan(b, 9024, q_emb.shape[1],
                                 cuda.M.sm_count(cuda.dev),
                                 cuda.M.MIN_COUNT_ITEM_STEPS)[1] > 1
    _scan(cuda, q_emb, emb, zc, 8999, seq_len, shift)


def _launch(g, q_emb, emb, zc, n_valid, seq_len, shift, with_count, splits):
    """min_count through the library's C entry at ``splits`` db splits:
    (key, cnt), cnt None without the count."""
    from smafa_tpu_torch.ops import _build

    torch = g.torch
    b, ep = q_emb.shape
    key = torch.full((b,), -7, dtype=torch.int32, device=g.dev)
    cnt = torch.full((b,), -7, dtype=torch.int32, device=g.dev)
    part = torch.empty((2, splits, b), dtype=torch.int32, device=g.dev)
    rc = _build.load().smafa_min_count(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), key.data_ptr(),
        cnt.data_ptr(), part.data_ptr(), b, n_valid, ep, seq_len, shift,
        int(with_count), splits, torch.cuda.current_stream(g.dev).cuda_stream)
    _build.check(rc, "min_count")
    return (key, cnt) if with_count else (key,)


def _held(g, q_emb, emb, zc, n_valid, seq_len, shift, splits=(1, 7)):
    """The C entry at each of ``splits``, at the plan's splits and at
    ceil(n_valid / 64), with and without the count, and the wrapper
    (``_scan``), equal the plain version; the plan is the short route.
    Returns (dist, idx, cnt) as numpy."""
    torch = g.torch
    route, s = _plan(g, q_emb.shape[0], n_valid, q_emb.shape[1])
    tiles = -(-n_valid // WP_MULTIPLE)
    assert route == "wgmma" and 1 <= s <= tiles
    for with_count in (False, True):
        want = g.D.min_count_reference(q_emb, emb, zc, n_valid, seq_len,
                                       shift, with_count)
        for n in sorted({min(x, tiles) for x in (*splits, s, tiles)}):
            got = _launch(g, q_emb, emb, zc, n_valid, seq_len, shift,
                          with_count, n)
            torch.cuda.synchronize()
            for a, w in zip(got, want):
                assert torch.equal(a, w), (n, with_count)
    return _scan(g, q_emb, emb, zc, n_valid, seq_len, shift)


def _copies_past(seq_len, wp, b, n_valid, seed):
    """A wp-row buffer and b reads two substitutions off its first
    n_valid rows; the rows just past n_valid are exact copies of the
    reads (each would win at distance 0 if it were read)."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    q[:, :2] = (q[:, :2] + 1) % 4
    past = min(b, wp - n_valid)
    buf[n_valid:n_valid + past] = q[:past]
    return buf, q


@pytest.mark.parametrize("seq_len", [3, 32, 33, 60, 63, 64])
def test_min_count_wg_widths_and_batches(cuda, seq_len):
    """Each width at B = 1 and 77, n_valid = 37 (below one block), 3001
    (ragged) and 4096 (whole blocks) in a 4,224-row buffer whose rows
    just past n_valid match the reads better than any live row."""
    for b in (1, 77):
        for n_valid in (37, 3001, 4096):
            buf, q = _copies_past(seq_len, 4224, b, n_valid,
                                  seq_len * 1000 + n_valid + b)
            emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
            dist, idx, cnt = _held(cuda, q_emb, emb, zc, n_valid, seq_len,
                                   shift)
            full = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
            np.testing.assert_array_equal(dist, full.min(axis=1))
            np.testing.assert_array_equal(idx, full.argmin(axis=1))
            np.testing.assert_array_equal(
                cnt, (full == full.min(axis=1)[:, None]).sum(axis=1))


@pytest.mark.parametrize("seq_len", [33, 60, 64])
def test_min_count_wg_32768_reads(cuda, seq_len):
    """32,768 reads (128 query tiles, the plan's one split) against 3001
    live rows of a 4,224-row buffer, the rows past n_valid copies of
    reads."""
    buf, q = _copies_past(seq_len, 4224, 32768, 3001, seq_len)
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    assert _plan(cuda, 32768, 3001, q_emb.shape[1]) == ("wgmma", 1)
    _held(cuda, q_emb, emb, zc, 3001, seq_len, shift)


def test_min_count_wg_repeated_40_times(cuda):
    """60 bp, 77 reads against 4,097 live rows of a 4,224-row buffer
    (the last block holds one), at 1 and at the plan's splits, without
    the count (the lightest epilogue), 40 times: every run equals the
    plain version. A zc slot refilled before its read would move a
    distance in a different few rows each run."""
    seq_len, n_valid, b = 60, 4097, 77
    buf, q = _copies_past(seq_len, 4224, b, n_valid, 40)
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    want = cuda.D.min_count_reference(q_emb, emb, zc, n_valid, seq_len,
                                      shift, False)[0]
    _, s = _plan(cuda, b, n_valid, q_emb.shape[1])
    for run in range(40):
        for n in (1, s):
            (key,) = _launch(cuda, q_emb, emb, zc, n_valid, seq_len, shift,
                             False, n)
            cuda.torch.cuda.synchronize()
            assert cuda.torch.equal(key, want), (run, n)


def test_min_count_wg_zc_of_the_callers_is_a_tma_source(cuda, monkeypatch):
    """At 60 bp the cluster's centroid buffer (and the spans of a cut
    key budget) and the stream layout's slabs, resident and streamed,
    hand kstats and min_count a zc that is 16-byte aligned; each scan
    equals the plain version."""
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    torch, D = cuda.torch, cuda.D
    seq_len = 60
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (3001, seq_len), dtype=np.uint8)
    q = codes[rng.integers(0, 3001, 77)].copy()
    store = cuda.CL._CentroidStore.from_codes(codes, cuda.dev)
    cuda.M.check_tma_zc(store.zc)
    for off in range(0, len(store), store.span):
        cuda.M.check_tma_zc(store.zc[off:off + store.span])
    before = cuda.MC.launches
    dist, idx = store.scan_fetch(store.scan_async(q))
    assert cuda.MC.launches > before
    assert (np.asarray(dist) == 0).all()
    seen = []
    for resident in ("1", "0"):
        monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT", resident)
        runner = SlabStreamRunner(codes, seq_len, cuda.dev, slab_rows=1024)
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(cuda.dev), seq_len)
        ts = torch.full((cuda.K.KSTATS_PROBES, 77), 5, dtype=torch.int32,
                        device=cuda.dev)

        def fold(emb, zc, _codes, n_valid, _off):
            cuda.M.check_tma_zc(zc)
            got = cuda.KS.kstats(q_emb, emb, zc, ts, n_valid, seq_len)
            want = D.stats_reference(q_emb, emb, zc, ts, n_valid, seq_len)
            for a, w in zip(got, want):
                assert torch.equal(a, w)
            seen.append(n_valid)
        runner._sweep(fold)
    assert seen == [1024, 1024, 953] * 2
