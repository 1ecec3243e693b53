"""The kstats kernel's split-W plan and merge, on the CPU.

The launch plan (``ops/min2.py:live_plan``) cuts only the live
64-row tiles, ceil(n_valid / 64) of them, into splits the way the kernel
does (split y of S walks tiles tiles * y // S up to tiles * (y + 1) //
S): every live tile once, none past n_valid's, one split when the query
tiles fill the card's SMs, the short route's plan (``short_plan``, the
wgmma tile of csrc/wg_scan.cuh) up to 64 bp and the K-chunked wgmma
tile's past it (tests/test_torch_long_plan.py), no launch at n_valid =
0. The
merge the kernel does (counts summed over the splits, maxima maxed) is
held on plain tensors: ``stats_reference`` over
each split's rows, merged, equals ``stats_reference`` over [0, n_valid)
and smafa_tpu's ``_statsN_pass`` on JAX CPU, exactly (every value is an
integer), also over a buffer whose rows past n_valid are live and
farther than every real row.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.ops import distance as D0
from smafa_tpu_torch.ops import keys as K

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE
H100_SMS = 132
BIG = (1 << 20) + 37


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import distance, kstats, min2

    return types.SimpleNamespace(torch=torch, D=distance, KS=kstats, M=min2)


def _plan(port, b: int, n_valid: int, ep: int, sms: int) -> tuple[str, int]:
    """kstats' plan: ``live_plan`` at its item cost."""
    return port.M.live_plan(b, n_valid, ep, sms, port.M.KSTATS_ITEM_STEPS)


def _split_rows(n_valid: int, s: int) -> list[tuple[int, int]]:
    """The db rows split y of s scans: whole live tiles, the last one cut
    at n_valid."""
    tiles = -(-n_valid // WP_MULTIPLE)
    return [(WP_MULTIPLE * (tiles * y // s),
             min(n_valid, WP_MULTIPLE * (tiles * (y + 1) // s)))
            for y in range(s)]


# (B, n_valid) -> splits on an H100 (132 SMs, one persistent block
# each): ``short_plan`` over qtiles = ceil(B / 256) query tiles and the
# live steps at KSTATS_ITEM_STEPS, at most one split per live tile
PLAN = {16384: {BIG: 33, 3001: 2, 37: 1}, 4096: {BIG: 33, 3001: 8, 37: 1},
        300: {BIG: 66, 3001: 47, 37: 1}, 1: {BIG: 132, 3001: 47, 37: 1}}


@pytest.mark.parametrize("b", sorted(PLAN))
def test_kstats_plan_covers_the_live_tiles(port, b):
    ep = port.D.embed_width(60)
    assert _plan(port, b, 0, ep, H100_SMS) == ("none", 0)
    for n_valid, want in PLAN[b].items():
        route, s = _plan(port, b, n_valid, ep, H100_SMS)
        tiles = -(-n_valid // WP_MULTIPLE)
        assert route == "wgmma" and s == want and 1 <= s <= tiles
        assert s == port.M.short_plan(b, tiles * WP_MULTIPLE, H100_SMS,
                                      port.M.KSTATS_ITEM_STEPS)
        cover = np.zeros(tiles + 1, np.int64)  # + 1: the tile past n_valid's
        for y in range(s):
            t0, t1 = tiles * y // s, tiles * (y + 1) // s
            assert t1 > t0
            cover[t0:t1] += 1
        assert (cover[:tiles] == 1).all() and cover[tiles] == 0
        rows = _split_rows(n_valid, s)
        assert rows[0][0] == 0 and rows[-1][1] == n_valid
        assert all(a[1] == b_[0] for a, b_ in zip(rows, rows[1:]))


def test_kstats_plan_one_split_when_query_tiles_fill_the_slots(port):
    """132 query tiles fill an H100's 132 SMs: one split, no merge, and
    so do 131; half as many take two. One tile more would leave a second
    wave of one item, so the splits even it out (64); at 2^20 reads (4096
    tiles) 12 splits even out the waves. Never more splits than live
    tiles, whatever the SMs."""
    ep = port.D.embed_width(60)
    for b in (256 * H100_SMS, 256 * (H100_SMS - 1)):
        assert _plan(port, b, BIG, ep, H100_SMS) == ("wgmma", 1)
    assert _plan(port, 256 * (H100_SMS // 2), BIG, ep, H100_SMS) == ("wgmma", 2)
    assert _plan(port, 256 * H100_SMS + 1, BIG, ep, H100_SMS) == ("wgmma", 64)
    assert _plan(port, 1 << 20, BIG, ep, H100_SMS) == ("wgmma", 12)
    assert _plan(port, 1, 3001, ep, 1000) == ("wgmma", 47)


def test_kstats_plan_routes_by_width(port):
    """Past 64 bp (EP > 256) kstats' plan is the K-chunked wgmma tile's,
    query rows resident up to 160 bp ("wg_kchunk") and streamed past it
    ("wg_kchunk_stream"), with ``long_plan``'s splits over the live
    rows at kstats' item cost, never more than the live steps; up to 64
    bp the short route, ``short_plan``'s splits over the live rows."""
    M = port.M
    for seq_len in (3, 60, 64, 65, 150, 160, 161, 168, 169, 300):
        ep = port.D.embed_width(seq_len)
        for b in (1, 77, 16384):
            for n_valid in (37, 3001, BIG):
                route, s = _plan(port, b, n_valid, ep, H100_SMS)
                tiles = -(-n_valid // WP_MULTIPLE)
                if seq_len > 160:
                    assert route == "wg_kchunk_stream"
                    assert 1 <= s <= -(-tiles // 2)
                elif seq_len > 64:
                    assert route == "wg_kchunk" and 1 <= s <= tiles
                else:
                    assert route == "wgmma" and 1 <= s <= tiles
                    assert s == M.short_plan(b, tiles * WP_MULTIPLE,
                                             H100_SMS, M.KSTATS_ITEM_STEPS)
                if seq_len > 64:
                    assert (route, s) == M.long_plan(
                        b, tiles * WP_MULTIPLE, ep, H100_SMS,
                        M.KSTATS_ITEM_STEPS)
            assert _plan(port, b, 0, ep, H100_SMS) == ("none", 0)


def _case(seq_len, wp, b, n_valid, seed, far=False):
    """A live buffer of wp rows and b queries mutated off its first
    n_valid rows; with ``far``, every row past n_valid lies at distance L
    from every query (codes 2-3 against queries of codes 0-1)."""
    rng = np.random.default_rng(seed)
    hi = 2 if far else 5
    buf = rng.integers(0, hi, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(0, n_valid, n_valid // 8)] = buf[1]
    q = buf[rng.integers(0, n_valid, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, hi, int(mut.sum())).astype(np.uint8)
    q[:3] = buf[1]
    if far:
        buf[n_valid:] += 2
    ts = rng.integers(-1, seq_len + 1, (K.KSTATS_PROBES, b)).astype(np.int32)
    ts[:, 3] = seq_len
    return buf, q, ts


def _merged_splits(port, q_emb, emb, zc, ts, n_valid, seq_len, s):
    """stats_reference over each split's rows, merged as the kernel's
    merge does: counts summed, maxima maxed."""
    parts = [port.D.stats_reference(q_emb, emb[a:e], zc[a:e], ts, e - a,
                                    seq_len)
             for a, e in _split_rows(n_valid, s)]
    cnt = sum(p[0] for p in parts)
    mx = port.torch.stack([p[1] for p in parts]).amax(dim=0)
    return cnt, mx


@pytest.mark.parametrize("sms", [2, H100_SMS])
@pytest.mark.parametrize("seq_len", [3, 60, 150])
def test_split_merge_equals_whole_and_statsN_pass(port, seq_len, sms):
    """n_valid = 517 of a 640-row live buffer (9 tiles, the last
    partial): on 132 SMs one tile per split, on 2 SMs 2 splits that do
    not divide the tiles. The long route (L = 150) runs one split, so
    the merge is held at the short route's plan for L = 60."""
    wp, b, n_valid = 640, 40, 517
    buf, q, ts_np = _case(seq_len, wp, b, n_valid, seq_len + sms)
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, wp)
    q_emb = port.D.expand_embed_query(from_numpy(q), seq_len)
    ts = from_numpy(ts_np)
    _, s = _plan(port, b, n_valid, port.D.embed_width(60), sms)
    assert s == (9 if sms == H100_SMS else 2)
    cnt, mx = _merged_splits(port, q_emb, emb, zc, ts, n_valid, seq_len, s)
    whole = port.D.stats_reference(q_emb, emb, zc, ts, n_valid, seq_len)
    want_cnt, want_mx = D0._statsN_pass(
        D0.expand_onehot(q, seq_len), D0.expand_onehot(buf, seq_len),
        jnp.int32(n_valid), jnp.asarray(ts_np), seq_len, 64)
    for got in ((cnt, mx), whole):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_cnt))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_mx))
    np.testing.assert_array_equal(cnt[:, 3].numpy(), n_valid)  # ts = L


@pytest.mark.parametrize("n_valid", [37, 517, 640])
def test_split_merge_ignores_far_live_rows(port, n_valid):
    """Rows past n_valid are live and farther than every real row (the
    distance L), so neither the merged max nor the counts at ts = L may
    see them: both equal the real rows' and ``_statsN_pass``'s."""
    seq_len, wp, b = 60, 704, 48
    buf, q, ts_np = _case(seq_len, wp, b, n_valid, n_valid, far=True)
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, wp)
    q_emb = port.D.expand_embed_query(from_numpy(q), seq_len)
    _, s = _plan(port, b, n_valid, port.D.embed_width(seq_len), 2)
    cnt, mx = _merged_splits(port, q_emb, emb, zc, from_numpy(ts_np), n_valid,
                             seq_len, s)
    dist = (q[:, None, :] != buf[None, :, :]).sum(axis=2)
    assert (dist[:, n_valid:] == seq_len).all()
    assert (dist[:, :n_valid].max(axis=1) < seq_len).all()
    np.testing.assert_array_equal(mx.numpy(), dist[:, :n_valid].max(axis=1))
    np.testing.assert_array_equal(
        cnt.numpy(), (dist[None, :, :n_valid] <= ts_np[:, :, None]).sum(axis=2))
    want_cnt, want_mx = D0._statsN_pass(
        D0.expand_onehot(q, seq_len), D0.expand_onehot(buf, seq_len),
        jnp.int32(n_valid), jnp.asarray(ts_np), seq_len, 64)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(want_mx))
