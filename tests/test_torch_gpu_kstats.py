"""The kstats kernel (one K-mode cutoff pass) against its plain PyTorch
version on the card: exact equality, one launch per call that scans, and
the route and db splits of its launch plan.

The short route (L <= 64, "wgmma": csrc/wg_scan.cuh's warp-specialised
tile, counts in byte lanes below 64 bp and in 16-bit pairs at 64 bp) at
B = 1, 16, 77 and 300 against 2^20 + 37 rows (many splits, the last
query tile partial, the last db block 37 rows); n_valid = 37 (one
partial block), 64 x 47 exactly and 3001, each in a longer buffer whose
rows past n_valid are live, among them exact copies of the queries and
rows at distance L from them; thresholds all -1, all L and equal across
the probes; a db of one repeated row; and the cutoff search at K past
the window count, where the cutoff is the row max. Then through the
library's C entry at 1, 7, the plan's and ceil(n_valid / 64) splits
(the last split owns the partial block at every count): L = 3, 32, 33,
60, 63 and 64 (the panel and byte-lane boundaries) at B = 1, 77 and
32768, n_valid below 64 and ragged, rows past n_valid that every
threshold would count; and more than PAIR_TILES (4095) blocks of one
repeated row in one split, in byte lanes and in pairs. Windows past 64
bp take the K-chunked route (tests/test_torch_gpu_kstats_long.py holds
it at every form and split).

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu

BIG = (1 << 20) + 37


def _plan(g, b, n_valid, ep):
    return g.M.live_plan(b, n_valid, ep, g.M.sm_count(g.dev),
                         g.M.KSTATS_ITEM_STEPS)


def _stats(g, q_emb, emb, zc, ts, n_valid, seq_len):
    """The kernel's (cnt, mx), held exactly to the plain version's; one
    launch when there is a row to scan."""
    ts = g.torch.from_numpy(np.ascontiguousarray(ts, np.int32)).to(g.dev)
    before = g.KS.launches
    got = g.KS.kstats(q_emb, emb, zc, ts, n_valid, seq_len)
    want = g.D.stats_reference(q_emb, emb, zc, ts, n_valid, seq_len)
    g.torch.cuda.synchronize()
    assert g.KS.launches == before + (n_valid > 0)
    for a, w in zip(got, want):
        assert g.torch.equal(a, w), n_valid
    return got


def _embed(g, buf, q, seq_len):
    wp = -(-buf.shape[0] // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(buf).to(g.dev), seq_len, wp)
    return emb, zc, g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev),
                                           seq_len)


@pytest.mark.parametrize("seq_len", [3, 60, 150, 300])
def test_kstats_kernel_equals_plain(cuda, seq_len):
    """A 5056-row buffer whose every row is live, scanned up to n_valid
    = 3001 (not a multiple of the 64-row tile), wp and 0 (no launch);
    B = 300 is not a multiple of the query block (256 rows). Then the cutoff
    search at K beyond the window count, where the cutoff is the row max:
    live rows past n_valid at larger distances must not raise it. L = 150
    and 300 take the K-chunked route, forms (a) and (b)."""
    torch, D = cuda.torch, cuda.D
    rng = np.random.default_rng(seq_len)
    wp, b = 5056, 300
    buf = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(0, 3001, 40)] = buf[5]
    q = buf[rng.integers(0, wp, b)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    q[:4] = buf[5]
    emb, zc = D.embed_db(torch.from_numpy(buf).to(cuda.dev), seq_len, wp)
    q_emb = D.expand_embed_query(torch.from_numpy(q).to(cuda.dev), seq_len)
    for n_valid in (3001, wp, 0):
        ts = torch.from_numpy(rng.integers(
            -1, seq_len + 1, (cuda.K.KSTATS_PROBES, b)).astype(np.int32)).to(cuda.dev)
        before = cuda.KS.launches
        got = cuda.KS.kstats(q_emb, emb, zc, ts, n_valid, seq_len)
        want = D.stats_reference(q_emb, emb, zc, ts, n_valid, seq_len)
        torch.cuda.synchronize()
        assert cuda.KS.launches == before + (n_valid > 0)
        for a, w in zip(got, want):
            assert torch.equal(a, w), n_valid
        if n_valid == 0:
            assert (got[1] == -1).all()
    for k, maxdiv in ((3002, seq_len + 1), (5, 1), (3002, seq_len // 2)):
        res = [D.kmode_phase1(
            lambda ts: fn(q_emb, emb, zc, ts, 3001, seq_len), k, maxdiv,
            3001, seq_len, b, cuda.dev)
            for fn in (cuda.KS.kstats, D.stats_reference)]
        for a, w in zip(*res):
            assert torch.equal(a, w), (k, maxdiv)


@pytest.mark.parametrize("b", [1, 16, 77, 300])
def test_kstats_split_kernel_equals_plain(cuda, b):
    """2^20 + 37 rows: every batch takes S > 1 splits and the merge; the
    last split masks the 37-row tile; B = 300 leaves most of the second
    query tile past B. Thresholds mix -1 and 0..L, and a tenth of the
    reads are exact copies of db rows."""
    seq_len = 60
    rng = np.random.default_rng(b)
    buf = rng.integers(0, 4, (BIG, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, BIG, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[: max(1, b // 10)] = buf[BIG - 1]  # the last, partial tile's last row
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    route, splits = _plan(cuda, b, BIG, q_emb.shape[1])
    assert route == "wgmma" and splits > 1
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
    ts[:, 0] = [0, 40, 45, seq_len]
    cnt, mx = _stats(cuda, q_emb, emb, zc, ts, BIG, seq_len)
    assert int(cnt[0, 0]) >= 1 and int(cnt[3, 0]) == BIG


@pytest.mark.parametrize("n_valid", [37, 64 * 47, 3001])
def test_kstats_live_rows_past_n_valid(cuda, n_valid):
    """A 70,016-row buffer scanned to n_valid: past it sit exact copies of
    the queries (they would add counts) and rows at distance L from them
    (they would raise the max), so both must be masked, on a one-tile
    db (37), a db of whole tiles (3008) and a partial last tile (3001)."""
    seq_len, wp, b = 60, 70016, 300
    rng = np.random.default_rng(n_valid)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    buf[n_valid:n_valid + b] = q
    buf[n_valid + b:n_valid + 2 * b] = (q + 2) % 4  # distance L
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    assert _plan(cuda, b, n_valid, q_emb.shape[1])[0] == "wgmma"
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
    ts[:, :8] = seq_len
    cnt, mx = _stats(cuda, q_emb, emb, zc, ts, n_valid, seq_len)
    dist = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
    np.testing.assert_array_equal(mx.cpu().numpy(), dist.max(axis=1))
    assert (cnt[:, :8] == n_valid).all()


@pytest.mark.parametrize("kind", ["off", "all", "equal"])
def test_kstats_extreme_thresholds(cuda, kind):
    """ts = -1 everywhere counts nothing; ts = L counts every real row;
    equal thresholds across the probes give four equal counts."""
    seq_len, nw, b = 60, 70001, 300
    rng = np.random.default_rng(11)
    buf = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, nw, b)].copy()
    q[1::2, :3] = (q[1::2, :3] + 1) % 5
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    P = cuda.K.KSTATS_PROBES
    if kind == "equal":
        ts = np.repeat(rng.integers(-1, seq_len + 1, (1, b)), P, axis=0)
    else:
        ts = np.full((P, b), -1 if kind == "off" else seq_len)
    cnt, _ = _stats(cuda, q_emb, emb, zc, ts, nw, seq_len)
    cnt = cnt.cpu().numpy()
    if kind == "off":
        assert (cnt == 0).all()
    elif kind == "all":
        assert (cnt == nw).all()
    else:
        assert (cnt == cnt[:1]).all() and cnt.max() > nw // 2


def test_kstats_repeated_row_db(cuda):
    """A db of one repeated row: every count is all the rows or none, and
    the max is the query's distance to the row."""
    seq_len, nw, b = 60, 70001, 300
    rng = np.random.default_rng(12)
    buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw, axis=0)
    q = buf[:b].copy()
    q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # distance 0 or 3
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
    ts[:, ::7] = 2
    cnt, mx = _stats(cuda, q_emb, emb, zc, ts, nw, seq_len)
    dist = (q != buf[0]).sum(axis=1)
    np.testing.assert_array_equal(mx.cpu().numpy(), dist)
    np.testing.assert_array_equal(cnt.cpu().numpy(),
                                  np.where(dist[None] <= ts, nw, 0))


def test_kstats_cutoff_past_the_window_count(cuda):
    """kmode_phase1 at K > n_windows over the kernel: the cutoff is
    the row max over the real rows, though the buffer's rows past them
    are live and farther."""
    torch, D = cuda.torch, cuda.D
    seq_len, nw, wp, b = 60, 70001, 70016 + 640, 77
    rng = np.random.default_rng(13)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, nw, b)].copy()
    buf[nw:nw + b] = (q + 2) % 4
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    res = [D.kmode_phase1(lambda ts: fn(q_emb, emb, zc, ts, nw, seq_len),
                          nw + 1, seq_len + 1, nw, seq_len, b, cuda.dev)
           for fn in (cuda.KS.kstats, D.stats_reference)]
    for a, w in zip(*res):
        assert torch.equal(a, w)
    eff, hits = res[0]
    row_max = [int((buf[:nw] != r).sum(axis=1).max()) for r in q]
    np.testing.assert_array_equal(eff.cpu().numpy(), row_max)
    assert (hits == nw).all()


def test_kstats_split_route_at_63_and_64_bp(cuda):
    """The widest windows of the short route: 63 bp counts four probes in
    the bytes of one register, 64 bp in 16-bit pairs; thresholds reach
    -1 and L. Byte lanes are exact only while every score q . db + zc of
    a real row lies in [0, 63]. The operands come from ``embed_db`` and
    ``expand_embed_query``, with code 0 on both sides, and reach both
    ends of [0, L] (an all-0 read against an all-0 row scores L, a read
    against a row of another code 0), so a change to the embedding that
    moves a score out of that range fails here."""
    nw, b = 9000, 300
    for seq_len in (63, 64):
        rng = np.random.default_rng(seq_len)
        buf = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
        buf[:4] = [[0], [1], [2], [3]]
        q = buf[rng.integers(0, nw, b)].copy()
        q[b // 2:][rng.random((b - b // 2, seq_len)) < 0.1] = 1
        q[:4] = [[0], [2], [1], [4]]
        emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
        scores = q_emb.float() @ emb[:8999].float().T + zc[:8999].float()
        assert int(scores.min()) == 0 and int(scores.max()) == seq_len
        assert _plan(cuda, b, nw, q_emb.shape[1])[0] == "wgmma"
        ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
        ts[:, :4] = [[-1], [0], [seq_len - 1], [seq_len]]
        cnt, mx = _stats(cuda, q_emb, emb, zc, ts, 8999, seq_len)
        assert (cnt[3, :4] == 8999).all() and (cnt[0, :4] == 0).all()
        assert int(mx.max()) == seq_len


@pytest.mark.parametrize("seq_len", [150, 300])
def test_kstats_long_route_equals_plain(cuda, seq_len):
    """Windows past 64 bp take the K-chunked wgmma tile: form (a), the
    query rows resident, at 150 bp, form (b), streamed, at 300 bp; 77
    reads x 9000 rows plan more than one split."""
    nw, b = 9000, 77
    rng = np.random.default_rng(seq_len)
    buf = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, nw, b)].copy()
    q[rng.random(q.shape) < 0.05] = 0
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    route, splits = _plan(cuda, b, nw, q_emb.shape[1])
    assert route == ("wg_kchunk" if seq_len <= 160 else "wg_kchunk_stream")
    assert splits > 1
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
    _stats(cuda, q_emb, emb, zc, ts, 8999, seq_len)


def _launch(g, q_emb, emb, zc, ts, n_valid, seq_len, splits):
    """kstats through the library's C entry at ``splits`` db splits."""
    from smafa_tpu_torch.ops import _build

    torch = g.torch
    b, ep = q_emb.shape
    cnt = torch.full(tuple(ts.shape), -7, dtype=torch.int32, device=g.dev)
    mx = torch.full((b,), -7, dtype=torch.int32, device=g.dev)
    part = torch.empty((ts.shape[0] + 1, splits, b), dtype=torch.int32,
                       device=g.dev)
    rc = _build.load().smafa_kstats(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), ts.data_ptr(),
        cnt.data_ptr(), mx.data_ptr(), part.data_ptr(), b, n_valid, ep,
        seq_len, splits, torch.cuda.current_stream(g.dev).cuda_stream)
    _build.check(rc, "kstats")
    return cnt, mx


def _held(g, q_emb, emb, zc, ts, n_valid, seq_len, splits=(1, 7)):
    """The C entry at each of ``splits``, at the plan's splits and at
    ceil(n_valid / 64), and the wrapper, equal the plain version; the
    plan is the short route. Returns (cnt, mx) as numpy."""
    torch = g.torch
    ts = torch.from_numpy(np.ascontiguousarray(ts, np.int32)).to(g.dev)
    want = g.D.stats_reference(q_emb, emb, zc, ts, n_valid, seq_len)
    route, s = _plan(g, q_emb.shape[0], n_valid, q_emb.shape[1])
    tiles = -(-n_valid // WP_MULTIPLE)
    assert route == "wgmma" and 1 <= s <= tiles
    for n in sorted({min(x, tiles) for x in (*splits, s, tiles)}):
        got = _launch(g, q_emb, emb, zc, ts, n_valid, seq_len, n)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert torch.equal(a, w), n
    _stats(g, q_emb, emb, zc, ts.cpu().numpy(), n_valid, seq_len)
    return want[0].cpu().numpy(), want[1].cpu().numpy()


@pytest.mark.parametrize("seq_len", [3, 32, 33, 60, 63, 64])
def test_kstats_wg_widths_and_batches(cuda, seq_len):
    """Each width at B = 1 and 77, n_valid = 37 (below one block), 3001
    (ragged) and 4096 (whole blocks) in a 4,224-row buffer whose rows
    past n_valid are exact copies of the reads (each would count at
    every threshold), thresholds mixing -1, 0 and L."""
    wp = 4224
    for b in (1, 77):
        for n_valid in (37, 3001, 4096):
            rng = np.random.default_rng(seq_len * 1000 + n_valid + b)
            buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
            q = buf[rng.integers(0, n_valid, b)].copy()
            q[:, :1] = (q[:, :1] + 1) % 4
            past = min(b, wp - n_valid)
            buf[n_valid:n_valid + past] = q[:past]
            emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
            ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
            ts[0] = 0
            ts[3, ::2] = seq_len
            cnt, mx = _held(cuda, q_emb, emb, zc, ts, n_valid, seq_len)
            dist = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
            np.testing.assert_array_equal(mx, dist.max(axis=1))
            if seq_len >= 32:  # no read lies at distance 0
                assert (cnt[0] == 0).all()
            assert (cnt[3, ::2] == n_valid).all()


@pytest.mark.parametrize("seq_len", [33, 60, 64])
def test_kstats_wg_32768_reads(cuda, seq_len):
    """32,768 reads (128 query tiles) against 3001 rows, byte lanes and
    pairs."""
    emb, zc, q_emb, _ = operands(cuda, seq_len, 3001, 32768, seq_len)
    rng = np.random.default_rng(seq_len)
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, 32768))
    _held(cuda, q_emb, emb, zc, ts, 3001, seq_len)


@pytest.mark.parametrize("seq_len", [60, 64])
def test_kstats_wg_flushes_every_pair_count(cuda, seq_len):
    """One split over 4,097 blocks of one repeated row and 37 rows more,
    in byte lanes (60 bp) and pairs (64 bp): every lane's counts fill
    (16 a block), flush every PAIR_TILES blocks and pass 65,535; each
    count is every row or none, at thresholds below, at and above each
    read's distance."""
    nw, b = 4097 * 64 + 37, 33
    rng = np.random.default_rng(seq_len)
    row = rng.integers(0, 4, (1, seq_len), dtype=np.uint8)
    buf = np.repeat(row, nw, axis=0)
    q = np.repeat(row, b, axis=0)
    q[:, :5] = (q[:, :5] + (np.arange(b)[:, None] % 3)) % 4  # dist 0 or 5
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    dist = (q != row).sum(axis=1)
    ts = np.stack([dist - 1, dist, np.full(b, seq_len), np.full(b, -1)])
    cnt, mx = _held(cuda, q_emb, emb, zc, ts, nw, seq_len, splits=(1,))
    np.testing.assert_array_equal(mx, dist)
    np.testing.assert_array_equal(cnt, np.where(dist[None] <= ts, nw, 0))
    assert (cnt[1] == nw).all() and nw > 65535
