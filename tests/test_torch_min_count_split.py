"""The min_count kernel's split-W plan and merge, on the CPU.

The launch plan (``ops/min2.py:live_plan``, which kstats' wrapper
calls too) cuts only the live 64-row tiles, ceil(n_valid / 64) of
them, into splits the way the kernel does (split y of S walks tiles
tiles * y // S up to tiles * (y + 1) // S): every live tile once, none
past n_valid's, one split when the query tiles fill the card's SMs,
the short route's plan (``short_plan``, the wgmma tile of
csrc/wg_scan.cuh) up to 64 bp and the K-chunked wgmma tile's past it
(form (b) in steps of two tiles), no launch at n_valid = 0. The
merge the kernel does (the min of the splits' keys;
with the count, the sum of the counts of the splits whose partial
distance is the row's minimum) is held on plain tensors:
``min_count_reference`` over each split's rows, merged, equals
``min_count_reference`` over [0, n_valid) and smafa_tpu's
``min_count_scan`` in interpret mode, exactly (every value is an
integer), with a tie across a split boundary (the lower index wins, the
counts add) and live rows past n_valid that would win if they were read.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.ops import distance as D0
from smafa_tpu.ops import pallas_scan as PS
from smafa_tpu_torch.ops import keys as K

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE
H100_SMS = 132


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import distance, kstats, min2, min_count

    return types.SimpleNamespace(torch=torch, D=distance, KS=kstats, M=min2,
                                 MC=min_count)


def _plan(port, b: int, n_valid: int, ep: int, sms: int) -> tuple[str, int]:
    """min_count's plan: ``live_plan`` at its item cost."""
    return port.M.live_plan(b, n_valid, ep, sms, port.M.MIN_COUNT_ITEM_STEPS)


def _split_rows(n_valid: int, s: int,
                step: int = WP_MULTIPLE) -> list[tuple[int, int]]:
    """The db rows split y of s scans: whole live steps of ``step`` rows
    (64-row tiles; form (b)'s steps of 128), the last one cut at
    n_valid."""
    tiles = -(-n_valid // step)
    return [(step * (tiles * y // s),
             min(n_valid, step * (tiles * (y + 1) // s)))
            for y in range(s)]


# (B, n_valid) -> splits on an H100 (132 SMs, one persistent block
# each): ``short_plan`` over qtiles = ceil(B / 256) query tiles and the
# live steps at MIN_COUNT_ITEM_STEPS, at most one split per live tile
# (the cluster's batches 2048-32768 against its centroid counts)
PLAN = {32768: {32768: 1, 29321: 1, 4096: 1, 37: 1, 1: 1},
        2048: {32768: 16, 29321: 16, 4096: 16, 37: 1, 1: 1},
        77: {32768: 132, 29321: 132, 4096: 64, 37: 1, 1: 1},
        1: {32768: 132, 29321: 132, 4096: 64, 37: 1, 1: 1}}


@pytest.mark.parametrize("b", sorted(PLAN))
def test_min_count_plan_covers_the_live_tiles(port, b):
    ep = port.D.embed_width(60)
    for n_valid, want in PLAN[b].items():
        route, s = _plan(port, b, n_valid, ep, H100_SMS)
        tiles = -(-n_valid // WP_MULTIPLE)
        assert route == "wgmma" and s == want and 1 <= s <= tiles
        assert s == port.M.short_plan(b, tiles * WP_MULTIPLE, H100_SMS,
                                      port.M.MIN_COUNT_ITEM_STEPS)
        cover = np.zeros(tiles + 1, np.int64)  # + 1: the tile past n_valid's
        for y in range(s):
            t0, t1 = tiles * y // s, tiles * (y + 1) // s
            assert t1 > t0
            cover[t0:t1] += 1
        assert (cover[:tiles] == 1).all() and cover[tiles] == 0
        rows = _split_rows(n_valid, s)
        assert rows[0][0] == 0 and rows[-1][1] == n_valid
        assert all(a[1] == b_[0] for a, b_ in zip(rows, rows[1:]))


def test_min_count_plan_is_kstats_plan_and_scans_nothing_at_zero(port):
    """One function plans both scans over the first n_valid rows: both
    wrappers call min2's live_plan and keep no plan of their own. At
    n_valid = 0 (the cluster's first batch) or B = 0 it plans no launch."""
    import inspect

    for mod, fn in ((port.MC, port.MC.min_count), (port.KS, port.KS.kstats)):
        assert "M.live_plan(b, n_valid, ep," in inspect.getsource(fn)
        assert not hasattr(mod, "launch_plan") and not hasattr(mod, "live_plan")
    for seq_len in (3, 60, 150):
        ep = port.D.embed_width(seq_len)
        for b in (1, 77, 2048, 32768):
            assert _plan(port, b, 0, ep, H100_SMS) == ("none", 0)
        assert _plan(port, 0, 4096, ep, H100_SMS) == ("none", 0)


def test_min_count_plan_one_split_when_query_tiles_fill_the_slots(port):
    """132 query tiles fill an H100's 132 SMs: one split, no merge, and
    so do 131 and 2^20 reads; half as many take two, and one tile more
    four (a second wave of one item, evened out at min_count's item
    cost). 32 query tiles against 256 live steps take 4 splits (128
    items on 132 SMs)."""
    ep = port.D.embed_width(60)
    for b in (256 * H100_SMS, 256 * (H100_SMS - 1), 1 << 20):
        assert _plan(port, b, 32768, ep, H100_SMS) == ("wgmma", 1)
    assert _plan(port, 256 * (H100_SMS // 2), 32768, ep, H100_SMS) == ("wgmma", 2)
    assert _plan(port, 256 * H100_SMS + 1, 32768, ep, H100_SMS) == ("wgmma", 4)
    assert _plan(port, 8192, 16384, ep, H100_SMS) == ("wgmma", 4)


def test_min_count_plan_routes_by_width(port):
    """Past 64 bp (EP > 256) the K-chunked wgmma tile, "wg_kchunk" up to
    160 bp and "wg_kchunk_stream" past it, with ``long_plan``'s splits
    over the live rows at min_count's item cost, never more than the
    live steps, at any batch and n_valid; up to 64 bp the short route,
    ``short_plan``'s splits over the live rows."""
    M = port.M
    for seq_len in (3, 60, 63, 64, 65, 150, 160, 161, 300):
        ep = port.D.embed_width(seq_len)
        for b in (1, 77, 2048, 32768):
            for n_valid in (1, 37, 4096, 29321):
                route, s = _plan(port, b, n_valid, ep, H100_SMS)
                tiles = -(-n_valid // 64)
                assert 1 <= s <= tiles
                if seq_len > 64:
                    assert route == ("wg_kchunk" if seq_len <= 160
                                     else "wg_kchunk_stream")
                    assert (route, s) == M.long_plan(
                        b, tiles * 64, ep, H100_SMS, M.MIN_COUNT_ITEM_STEPS)
                    if route == "wg_kchunk_stream":
                        assert s <= -(-tiles // 2)
                else:
                    assert route == "wgmma"
                    assert s == M.short_plan(b, tiles * 64, H100_SMS,
                                             M.MIN_COUNT_ITEM_STEPS)


def _merged_splits(port, q_emb, emb, zc, n_valid, seq_len, shift, s,
                   with_count, step=WP_MULTIPLE):
    """min_count_reference over each split's rows, its keys moved to the
    buffer's row indices, merged as the kernel's merge does: the min of
    the keys; with the count, the counts of the splits whose distance is
    the row's minimum, summed."""
    torch = port.torch
    keys, cnts = [], []
    for a, e in _split_rows(n_valid, s, step):
        key, cnt = port.D.min_count_reference(q_emb, emb[a:e], zc[a:e], e - a,
                                              seq_len, shift, True)
        assert (key != K.BIG_KEY).all()  # every split holds a live row
        keys.append(key + a)  # (dist << shift) | (w - a), w < 2^shift
        cnts.append(cnt)
    keys = torch.stack(keys)
    key = keys.amin(dim=0)
    if not with_count:
        return (key,)
    at_min = (keys >> shift) == (key >> shift)
    return key, torch.where(at_min, torch.stack(cnts), 0).sum(dim=0,
                                                             dtype=torch.int32)


def _pallas(buf, q, n_valid, seq_len):
    """smafa_tpu's min_count_scan in interpret mode over the whole live
    buffer (padded to its 128-row tile) with n_valid real windows:
    (dist, idx, cnt)."""
    tb, tw = 8, 128
    wp = -(-buf.shape[0] // tw) * tw
    bp = -(-q.shape[0] // tb) * tb
    q_p = np.pad(np.asarray(D0.expand_onehot(q, seq_len)),
                 [(0, bp - q.shape[0]), (0, 0)])
    db_p = np.pad(np.asarray(D0.expand_onehot(buf, seq_len)),
                  [(0, wp - buf.shape[0]), (0, 0)])
    out = PS.min_count_scan(jnp.asarray(q_p), jnp.asarray(db_p),
                            jnp.asarray([n_valid], jnp.int32), seq_len,
                            PS.packing_shift(seq_len, wp), tb, tw,
                            interpret=True)
    return [np.asarray(x)[:q.shape[0]] for x in out]


def _case(seq_len, wp, b, n_valid, seed):
    """A live buffer of wp rows and b queries off its first n_valid rows,
    with: q[0] an exact match of rows 130, 200, 300 and n_valid - 1 (a
    4-way tie over three splits and the partial tile); q[1] an exact copy
    of row n_valid + 3, past n_valid, and q[2] of row n_valid (in the
    partial tile's masked part when n_valid % 64); q[3] an exact match of
    rows 127 and 128 (a tie across the split boundary of both plans)."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    buf[[200, 300, n_valid - 1]] = buf[130]
    buf[128] = buf[127]
    q[0], q[1], q[2], q[3] = buf[130], buf[n_valid + 3], buf[n_valid], buf[127]
    return buf, q


@pytest.mark.parametrize("with_count", [True, False])
@pytest.mark.parametrize("seq_len", [3, 60, 150, 300])
def test_split_merge_equals_whole_and_min_count_scan(port, seq_len,
                                                     with_count):
    """n_valid = 517 of a 640-row live buffer (9 tiles, the last holding
    5 live rows), at the plan of this width: on 132 SMs one tile per
    split (one 128-row step per split at 300 bp, form (b): 5, the last
    holding one live block); on 4 SMs 4 splits that do not divide the
    tiles (or steps)."""
    wp, b, n_valid = 640, 40, 517
    buf, q = _case(seq_len, wp, b, n_valid, seq_len + with_count)
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, wp)
    q_emb = port.D.expand_embed_query(from_numpy(q), seq_len)
    shift = K.packing_shift(seq_len, wp)
    want = _pallas(buf, q, n_valid, seq_len)
    whole = port.D.min_count_reference(q_emb, emb, zc, n_valid, seq_len,
                                       shift, with_count)
    route = ("wgmma" if seq_len <= 64 else
             "wg_kchunk" if seq_len <= 160 else "wg_kchunk_stream")
    step = 128 if route == "wg_kchunk_stream" else WP_MULTIPLE
    for sms, s in ((4, 4),
                   (H100_SMS, 5 if step == 128 else 9)):
        assert _plan(port, b, n_valid, port.D.embed_width(seq_len),
                     sms) == (route, s)
        got = _merged_splits(port, q_emb, emb, zc, n_valid, seq_len, shift,
                             s, with_count, step)
        assert len(got) == len(whole) == 1 + with_count
        for g, w in zip(got, whole):
            assert port.torch.equal(g, w), s
        dist, idx = (t.numpy() for t in port.D.unpack_min_key(got[0], shift))
        np.testing.assert_array_equal(dist, want[0])
        np.testing.assert_array_equal(idx, want[1])
        if with_count:
            np.testing.assert_array_equal(got[1].numpy(), want[2])
    if seq_len > 3:  # at 3 bp chance matches blur the planted ones
        assert (dist[[0, 3]] == 0).all() and list(idx[[0, 3]]) == [130, 127]
        if with_count:
            assert list(got[1][[0, 3]]) == [4, 2]


@pytest.mark.parametrize("n_valid", [37, 517, 640])
def test_split_merge_ignores_live_rows_past_n_valid(port, n_valid):
    """Past n_valid the buffer holds exact copies of every query, which
    would win (distance 0) if they were read: the merged keys and counts
    equal a brute force over the first n_valid rows and min_count_scan's,
    with and without the count."""
    seq_len, wp, b = 60, 704, 48
    rng = np.random.default_rng(n_valid)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    q[:, :2] = (q[:, :2] + 1) % 4  # two substitutions: distance >= 2
    buf[n_valid:n_valid + b] = q
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, wp)
    q_emb = port.D.expand_embed_query(from_numpy(q), seq_len)
    shift = K.packing_shift(seq_len, wp)
    dist = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
    assert dist.min() >= 1
    want = _pallas(buf, q, n_valid, seq_len)
    for sms in (2, H100_SMS):
        _, s = _plan(port, b, n_valid, port.D.embed_width(seq_len), sms)
        for with_count in (True, False):
            got = _merged_splits(port, q_emb, emb, zc, n_valid, seq_len,
                                 shift, s, with_count)
            d, i = (t.numpy() for t in port.D.unpack_min_key(got[0], shift))
            np.testing.assert_array_equal(d, dist.min(axis=1))
            np.testing.assert_array_equal(i, dist.argmin(axis=1))
            np.testing.assert_array_equal(d, want[0])
            np.testing.assert_array_equal(i, want[1])
            if with_count:
                np.testing.assert_array_equal(
                    got[1].numpy(), (dist == dist.min(axis=1)[:, None]).sum(axis=1))
                np.testing.assert_array_equal(got[1].numpy(), want[2])


def test_split_merge_counts_a_repeated_row_across_every_split(port):
    """A db of one repeated row: every split's rows tie, so the merged
    count is n_valid and the key's index 0, at 1, 4 and 9 splits."""
    seq_len, wp, b, n_valid = 60, 640, 16, 517
    rng = np.random.default_rng(5)
    buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), wp, axis=0)
    q = buf[:b].copy()
    q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # distance 0 or 3
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, wp)
    q_emb = port.D.expand_embed_query(from_numpy(q), seq_len)
    shift = K.packing_shift(seq_len, wp)
    for s in (1, 4, 9):
        key, cnt = _merged_splits(port, q_emb, emb, zc, n_valid, seq_len,
                                  shift, s, True)
        d, i = (t.numpy() for t in port.D.unpack_min_key(key, shift))
        np.testing.assert_array_equal(d, (q != buf[0]).sum(axis=1))
        assert (i == 0).all() and (cnt == n_valid).all()
