"""kstats' long routes (windows past 64 bp, counts in 16-bit pairs), the
K-chunked wgmma tile of csrc/wg_long.cuh, against its plain PyTorch
version on the card, exact.

Form (a), "wg_kchunk", the query rows resident, serves EP <= 640 (L <=
160); form (b), "wg_kchunk_stream", query and db chunks streamed, serves
longer windows (161-168 bp among them). Each case runs at one split (no
merge), at the wrapper's plan, at 7 splits and at ceil(n_valid / 64)
splits (the C entry's most: in form (b) more splits than 128-row steps,
so some walk none), through the library's C entry, and once through the
wrapper, which must launch once and take the plan's route. Cases: L =
65, 127, 150, 160, 161, 168, 169 and 300, n_valid ending inside a block
with live rows past it (exact copies of the reads, which would count at
every threshold, and rows at distance L, which would raise the max);
n_valid ragged against the 64-row block and the 128-row step; thresholds
-1, L and equal across the probes; a db of one repeated row; more than
PAIR_TILES (4095) blocks in one split in both forms, so the 16-bit
counts flush and pass 65,535; both item orders of form (b); 29,903 bp on
a small db; and the cutoff search at K past the window count.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda  # noqa: F401

pytestmark = pytest.mark.gpu


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
    plan is the long route of this width. Returns (cnt, mx) as numpy."""
    torch = g.torch
    ts = torch.from_numpy(np.ascontiguousarray(ts, np.int32)).to(g.dev)
    want = g.D.stats_reference(q_emb, emb, zc, ts, n_valid, seq_len)
    b, ep = q_emb.shape
    route, s = g.M.live_plan(b, n_valid, ep, g.M.sm_count(g.dev),
                             g.M.KSTATS_ITEM_STEPS)
    tiles = -(-n_valid // WP_MULTIPLE)
    assert route == ("wg_kchunk" if ep <= 640 else "wg_kchunk_stream")
    assert 1 <= s <= tiles
    for n in sorted({min(x, tiles) for x in (*splits, s, tiles)}):
        got = _launch(g, q_emb, emb, zc, ts, n_valid, seq_len, n)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert torch.equal(a, w), n
    before = g.KS.launches
    got = g.KS.kstats(q_emb, emb, zc, ts, n_valid, seq_len)
    torch.cuda.synchronize()
    assert g.KS.launches == before + 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    return want[0].cpu().numpy(), want[1].cpu().numpy()


def _embed(g, buf, q, seq_len):
    wp = -(-buf.shape[0] // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(buf).to(g.dev), seq_len, wp)
    return emb, zc, g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev),
                                           seq_len)


@pytest.mark.parametrize("seq_len", [65, 127, 150, 160, 161, 168, 169, 300])
def test_kstats_kchunk_equals_plain(cuda, seq_len):
    """A 5056-row live buffer scanned to n_valid = 3001 (a partial last
    tile) with exact copies of the reads and rows at distance L from
    them past it; 300 reads, thresholds in [-1, L], the first 8 at L
    (every real row counts). Then the cutoff search at K past the
    window count, where the cutoff is the row max over the real rows."""
    torch, D = cuda.torch, cuda.D
    wp, b, n_valid = 5056, 300, 3001
    rng = np.random.default_rng(seq_len)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(0, n_valid, 40)] = buf[5]
    q = buf[rng.integers(0, n_valid, b)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[:4] = buf[5]
    buf[n_valid:n_valid + b] = q
    buf[n_valid + b:n_valid + 2 * b] = (q + 2) % 4  # distance L
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
    ts[:, :8] = seq_len
    cnt, mx = _held(cuda, q_emb, emb, zc, ts, n_valid, seq_len)
    dist = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
    np.testing.assert_array_equal(mx, dist.max(axis=1))
    assert (cnt[:, :8] == n_valid).all()
    res = [D.kmode_phase1(
        lambda t: fn(q_emb, emb, zc, t, n_valid, seq_len), n_valid + 1,
        seq_len + 1, n_valid, seq_len, b, cuda.dev)
        for fn in (cuda.KS.kstats, D.stats_reference)]
    for a, w in zip(*res):
        assert torch.equal(a, w)


@pytest.mark.parametrize("kind", ["off", "all", "equal"])
def test_kstats_kchunk_extreme_thresholds(cuda, kind):
    """ts = -1 everywhere counts nothing; ts = L counts every real row;
    equal thresholds across the probes give four equal counts; in both
    forms (150 and 300 bp)."""
    nw, b = 9001, 77
    for seq_len in (150, 300):
        rng = np.random.default_rng(seq_len)
        buf = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
        q = buf[rng.integers(0, nw, b)].copy()
        q[1::2, :9] = (q[1::2, :9] + 1) % 5
        emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
        P = cuda.K.KSTATS_PROBES
        if kind == "equal":
            ts = np.repeat(rng.integers(-1, seq_len + 1, (1, b)), P, axis=0)
        else:
            ts = np.full((P, b), -1 if kind == "off" else seq_len)
        cnt, _ = _held(cuda, q_emb, emb, zc, ts, nw, seq_len)
        if kind == "off":
            assert (cnt == 0).all()
        elif kind == "all":
            assert (cnt == nw).all()
        else:
            assert (cnt == cnt[:1]).all() and cnt.max() > nw // 2


def test_kstats_kchunk_repeated_row_db(cuda):
    """A db of one repeated row: every count is all the rows or none, and
    the max is the read's distance to the row, in both forms."""
    nw, b = 7001, 77
    for seq_len in (150, 300):
        rng = np.random.default_rng(seq_len + 1)
        buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw,
                        axis=0)
        q = buf[:b].copy()
        q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # dist 0 or 3
        emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
        ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
        ts[:, ::7] = 2
        cnt, mx = _held(cuda, q_emb, emb, zc, ts, nw, seq_len)
        dist = (q != buf[0]).sum(axis=1)
        np.testing.assert_array_equal(mx, dist)
        np.testing.assert_array_equal(cnt, np.where(dist[None] <= ts, nw, 0))


def test_kstats_kchunk_flushes_pair_counts(cuda):
    """270,001 rows at 65 bp in one split: 4,219 blocks, past PAIR_TILES,
    so the 16-bit counts flush once mid-run, and at ts = L a count
    (270,001) passes 65,535."""
    seq_len, nw, b = 65, 270001, 33
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 4, (nw, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, nw, b)].copy()
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
    ts[3] = seq_len
    cnt, _ = _held(cuda, q_emb, emb, zc, ts, nw, seq_len, splits=(1, 2))
    assert (cnt[3] == nw).all()


def test_kstats_stream_flushes_every_pair_count(cuda):
    """Form (b) (300 bp), one split over 4,097 blocks of one repeated row
    and 37 rows more: every lane's pair counts fill (16 a block) and
    flush by blocks, not 128-row steps; each count is every row or none,
    at thresholds below, at and above each read's distance."""
    seq_len, nw, b = 300, 4097 * 64 + 37, 33
    rng = np.random.default_rng(9)
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


@pytest.mark.parametrize("n_valid", [4097, 4160, 4223, 4224])
def test_kstats_ragged_live_rows(cuda, n_valid):
    """n_valid against the 64-row block and the 128-row step (65 or 66
    live blocks, the last partial or whole) in both forms, the rows past
    it exact copies of the reads (each would count at every threshold)
    and rows at distance L (each would raise the max)."""
    wp, b = 4352, 70
    for seq_len in (150, 300):
        rng = np.random.default_rng(n_valid + seq_len)
        buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
        q = buf[rng.integers(0, n_valid, b)].copy()
        q[:, :3] = (q[:, :3] + 1) % 4
        past = min(b, wp - n_valid)
        buf[n_valid:n_valid + past] = q[:past]
        buf[n_valid + past:] = (q[0] + 2) % 4  # distance L from read 0
        emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
        ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
        ts[0] = 0
        cnt, mx = _held(cuda, q_emb, emb, zc, ts, n_valid, seq_len)
        dist = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
        np.testing.assert_array_equal(mx, dist.max(axis=1))
        assert (cnt[0] == 0).all()  # no read lies at distance 0


@pytest.mark.parametrize("splits", [8, 33])
def test_kstats_stream_item_orders(cuda, splits):
    """Form (b) at 300 bp, 1,024 reads (4 query tiles) x 32,768 rows
    through the C entry: 8 splits put every item in the grid with the
    splits at most twice the query tiles (db split fastest), 33 do not
    (query tile fastest); both orders exact."""
    seq_len, nw, b = 300, 32768, 1024
    rng = np.random.default_rng(splits)
    buf = rng.integers(0, 4, (nw, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, nw, b)].copy()
    q[rng.random(q.shape) < 0.05] = 1
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    qtiles, sms = -(-b // 256), cuda.M.sm_count(cuda.dev)
    assert (qtiles * splits <= sms and splits <= 2 * qtiles) == (splits == 8)
    ts = rng.integers(-1, seq_len + 1, (cuda.K.KSTATS_PROBES, b))
    _held(cuda, q_emb, emb, zc, ts, nw - 5, seq_len, splits=(splits,))


def test_kstats_kchunk_29903bp(cuda):
    """A SARS-CoV-2 genome's width, form (b): 637 of 640 live rows, 40
    reads copied off them with substitutions."""
    seq_len, nw, b = 29903, 640, 40
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 4, (nw, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, 637, b)].copy()
    mut = rng.random(q.shape) < 0.01
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    assert q_emb.shape[1] == 119616
    ts = rng.integers(0, 400, (cuda.K.KSTATS_PROBES, b))
    ts[3] = seq_len
    cnt, mx = _held(cuda, q_emb, emb, zc, ts, 637, seq_len)
    assert (cnt[3] == 637).all() and (mx <= seq_len).all()
