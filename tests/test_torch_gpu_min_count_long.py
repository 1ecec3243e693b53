"""min_count's long routes (windows past 64 bp), the K-chunked wgmma
tile of csrc/wg_long.cuh, against its plain PyTorch version on the
card, exact, with and without the count.

Form (a), "wg_kchunk", the query rows resident, serves EP <= 640 (L <=
160); form (b), "wg_kchunk_stream", query and db chunks streamed, serves
longer windows (161-168 bp among them). Each case runs at one split (no
merge), at the wrapper's plan, at 7 splits (a count that divides no run
of live blocks evenly) and at ceil(n_valid / 64) splits (the C entry's
most: in form (b) more splits than 128-row steps, so some walk none),
through the library's C entry, and once through the wrapper, which must
launch once and take the plan's route. Cases: L = 65, 150, 160, 161,
168, 169 and 300 over a buffer whose rows past n_valid are exact copies
of the reads (they would win if they were read); n_valid = 37, 3001 and
ragged against the 64-row block and the 128-row step; a db of one
repeated row (the count is every live row, summed across the splits); a
db whose only exact match is its last live row; batches of 1, 77 and
257 rows; form (a) at 3 panels (65 bp) run again and again, where the
zc slots once raced; both item orders of form (b); 29,903 bp on a small
db.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda  # noqa: F401

pytestmark = pytest.mark.gpu


def _launch(g, q_emb, emb, zc, n_valid, seq_len, shift, with_count,
            splits):
    """min_count through the library's C entry at ``splits`` db splits."""
    from smafa_tpu_torch.ops import _build

    torch = g.torch
    b, ep = q_emb.shape
    key = torch.full((b,), -7, dtype=torch.int32, device=g.dev)
    cnt = key.clone()
    part = torch.empty((2, splits, b), dtype=torch.int32, device=g.dev)
    rc = _build.load().smafa_min_count(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), key.data_ptr(),
        cnt.data_ptr(), part.data_ptr(), b, n_valid, ep, seq_len, shift,
        int(with_count), splits, torch.cuda.current_stream(g.dev).cuda_stream)
    _build.check(rc, "min_count")
    return (key, cnt) if with_count else (key,)


def _held(g, q_emb, emb, zc, n_valid, seq_len, shift, splits=(1, 7)):
    """With and without the count: the C entry at each of ``splits``, at
    the plan's and at ceil(n_valid / 64), and the wrapper, equal the
    plain version; the plan is the long route of this width over the
    live rows. Returns (dist, idx, cnt) as numpy."""
    torch = g.torch
    b, ep = q_emb.shape
    route, s = g.M.live_plan(b, n_valid, ep, g.M.sm_count(g.dev),
                             g.M.MIN_COUNT_ITEM_STEPS)
    tiles = -(-n_valid // WP_MULTIPLE)
    assert route == ("wg_kchunk" if ep <= 640 else "wg_kchunk_stream")
    assert 1 <= s <= tiles
    for with_count in (False, True):
        want = g.D.min_count_reference(q_emb, emb, zc, n_valid, seq_len,
                                       shift, with_count)
        for n in sorted({min(x, tiles) for x in (*splits, s, tiles)}):
            got = _launch(g, q_emb, emb, zc, n_valid, seq_len, shift,
                          with_count, n)
            torch.cuda.synchronize()
            for a, w in zip(got, want):
                assert torch.equal(a, w), (n, with_count)
        before = g.MC.launches
        got = g.MC.min_count(q_emb, emb, zc, n_valid, seq_len, shift,
                             with_count)
        torch.cuda.synchronize()
        assert g.MC.launches == before + 1
        assert len(got) == 1 + with_count
        for a, w in zip(got, want):
            assert torch.equal(a, w), with_count
    dist, idx = g.D.unpack_min_key(want[0], shift)
    return dist.cpu().numpy(), idx.cpu().numpy(), want[1].cpu().numpy()


def _embed(g, buf, q, seq_len):
    """(db_emb, zc, q_emb, shift) on the card, the buffer padded to the
    64-row tile."""
    wp = -(-buf.shape[0] // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(buf).to(g.dev), seq_len, wp)
    q_emb = g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev), seq_len)
    return emb, zc, q_emb, g.K.packing_shift(seq_len, wp)


def _copies_past(seq_len, wp, b, n_valid, seed):
    """A wp-row buffer and b reads off its first n_valid rows with two
    substitutions each; the rows past n_valid are exact copies of the
    reads (distance 0, which the scan must not see)."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    q[:, :2] = (q[:, :2] + 1) % 4
    buf[n_valid:n_valid + b] = q
    return buf, q


def _brute(buf, q, n_valid):
    """(min distance, first index at it, count at it) over rows below
    n_valid."""
    d = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
    m = d.min(axis=1)
    return m, d.argmin(axis=1), (d == m[:, None]).sum(axis=1)


@pytest.mark.parametrize("seq_len", [65, 150, 160, 161, 168, 169, 300])
def test_min_count_kchunk_equals_plain(cuda, seq_len):
    """n_valid = 3001 of a 5056-row buffer, 300 reads; the scan sees none
    of the copies past n_valid."""
    wp, b, n_valid = 5056, 300, 3001
    buf, q = _copies_past(seq_len, wp, b, n_valid, seq_len)
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    dist, idx, cnt = _held(cuda, q_emb, emb, zc, n_valid, seq_len, shift)
    want = _brute(buf, q, n_valid)
    for got, w in zip((dist, idx, cnt), want):
        np.testing.assert_array_equal(got, w)
    assert (dist >= 1).all()


@pytest.mark.parametrize("n_valid", [37, 3001, 4097, 4160, 4223])
def test_min_count_kchunk_partial_last_tile(cuda, n_valid):
    """The last live block holds n_valid % 64 live rows (or 64) and live
    copies of the reads after them, the live blocks odd or even against
    form (b)'s 128-row steps; the last split that walks any step owns
    it; both forms."""
    for seq_len in (150, 300):
        buf, q = _copies_past(seq_len, 4352, 77, n_valid, n_valid + seq_len)
        emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
        dist, idx, cnt = _held(cuda, q_emb, emb, zc, n_valid, seq_len, shift)
        for got, w in zip((dist, idx, cnt), _brute(buf, q, n_valid)):
            np.testing.assert_array_equal(got, w)


def test_min_count_kchunk_repeated_row_db(cuda):
    """A db of one repeated row: every read's count is every live row,
    summed across the splits, and its index 0; both forms."""
    nw, b, n_valid = 9024, 77, 9001
    for seq_len in (150, 300):
        rng = np.random.default_rng(seq_len + 3)
        buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw,
                        axis=0)
        q = buf[:b].copy()
        q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # dist 0 or 3
        emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
        dist, idx, cnt = _held(cuda, q_emb, emb, zc, n_valid, seq_len, shift)
        np.testing.assert_array_equal(dist, np.where(np.arange(b) % 4, 3, 0))
        assert (idx == 0).all() and (cnt == n_valid).all()


def test_min_count_kchunk_best_match_last_live_row(cuda):
    """Half the reads are exact copies of the last live row (row 7000 of
    7001), the only exact match; the rest are mutated copies of it.
    Both forms."""
    nw, b, n_valid = 7040, 77, 7001
    for seq_len in (150, 300):
        rng = np.random.default_rng(seq_len + 4)
        buf = rng.integers(0, 4, (nw, seq_len), dtype=np.uint8)
        q = np.repeat(buf[7000:7001], b, axis=0)
        mut = rng.random(q.shape) < 0.05
        mut[:38] = False
        q[mut] = (q[mut] + 1) % 4
        emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
        dist, idx, cnt = _held(cuda, q_emb, emb, zc, n_valid, seq_len, shift)
        assert (dist[:38] == 0).all() and (idx[:38] == 7000).all()
        assert (cnt[:38] == 1).all()


@pytest.mark.parametrize("b", [1, 77, 257])
def test_min_count_kchunk_small_batches(cuda, b):
    """Batches below the 256-row query block or one row past it: warps
    with no row below B copy and sync but write nothing; both forms."""
    for seq_len in (150, 300):
        buf, q = _copies_past(seq_len, 6272, b, 6001, b + seq_len)
        emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
        dist, idx, cnt = _held(cuda, q_emb, emb, zc, 6001, seq_len, shift)
        for got, w in zip((dist, idx, cnt), _brute(buf, q, 6001)):
            np.testing.assert_array_equal(got, w)


def test_min_count_kchunk_29903bp(cuda):
    """A SARS-CoV-2 genome's width, form (b), 468 chunks a row: 637 of
    640 live rows, 40 reads off them with ~1% substitutions, the first 4
    exact copies of row 636, the last live one."""
    seq_len, wp, b, n_valid = 29903, 640, 40, 637
    rng = np.random.default_rng(6)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    mut = rng.random(q.shape) < 0.01
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[:4] = buf[636]
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    assert q_emb.shape[1] == 119616
    dist, idx, _ = _held(cuda, q_emb, emb, zc, n_valid, seq_len, shift)
    assert (dist[:4] == 0).all() and (idx[:4] == 636).all()


def test_min_count_three_panels_repeated(cuda):
    """Form (a) at 3 panels (65 bp), whose 16-stage ring runs 5 steps
    ahead of the 4 zc slots, 4,096 reads x 32,768 rows without the
    count at 1 and 2 splits, 20 runs each: every run exact (the slots
    once raced, and a few rows a run came out off)."""
    torch = cuda.torch
    seq_len, nw, b = 65, 32768, 4096
    buf, q = _copies_past(seq_len, nw + b, b, nw, 11)
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    want = cuda.D.min_count_reference(q_emb, emb, zc, nw, seq_len, shift,
                                      False)
    for splits in (1, 2):
        for _ in range(20):
            got = _launch(cuda, q_emb, emb, zc, nw, seq_len, shift, False,
                          splits)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), splits


@pytest.mark.parametrize("splits", [8, 33])
def test_min_count_stream_item_orders(cuda, splits):
    """Form (b) at 300 bp, 1,024 reads (4 query tiles) x 32,768 rows
    through the C entry: 8 splits put every item in the grid with the
    splits at most twice the query tiles (db split fastest), 33 do not
    (query tile fastest); both orders exact."""
    seq_len, nw, b = 300, 32768, 1024
    buf, q = _copies_past(seq_len, nw + b, b, nw - 5, splits)
    emb, zc, q_emb, shift = _embed(cuda, buf, q, seq_len)
    qtiles, sms = -(-b // 256), cuda.M.sm_count(cuda.dev)
    assert (qtiles * splits <= sms and splits <= 2 * qtiles) == (splits == 8)
    _held(cuda, q_emb, emb, zc, nw - 5, seq_len, shift, splits=(splits,))
