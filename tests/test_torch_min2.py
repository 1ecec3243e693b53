"""The min2 wrapper on CPU tensors (its plain version) equals the Pallas
kernel it replaces (interpret mode) and the XLA min2_scan: identical
packed keys, and the fused tie count equal to the Pallas count and a
dense oracle. Exact equality: every value is an integer.

torch is imported by the ``port`` fixture, not at collection: a worker
that imported torch passes its resident size on to every subprocess it
starts (ru_maxrss survives exec), which other tests in the suite
measure."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.ops import distance as D0
from smafa_tpu.ops import pallas_scan as PS
from smafa_tpu_torch.ops import keys as K

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import distance, min2

    return types.SimpleNamespace(torch=torch, D=distance, M=min2)


def _case(seq_len, nw, b, seed):
    """Ragged db (nw real rows, padded to the kernels' multiple) with
    planted duplicate windows, and queries with exact copies."""
    rng = np.random.default_rng(seed)
    wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
    db = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    db[nw:] = 0
    db[:nw][rng.integers(0, nw, nw // 20 + 2)] = db[7]
    db[nw - 3:nw] = db[1]
    q = rng.integers(0, 5, (b, seq_len), dtype=np.uint8)
    q[:3] = db[7]
    q[3] = db[1]
    return db, q, wp


def _port(port, db, q, seq_len, nw, wp, with_count):
    D, from_numpy = port.D, port.torch.from_numpy
    emb, zc = D.embed_db(from_numpy(db[:nw]), seq_len, wp)
    q_emb = D.expand_embed_query(from_numpy(q), seq_len)
    shift = K.packing_shift(seq_len, wp)
    return [t.numpy() for t in port.M.min2(q_emb, emb, zc, seq_len, shift,
                                           with_count)]


def _xla(db, q, seq_len, nw, wp):
    shift = D0.packing_shift(seq_len, wp)
    lo, hi = D0.min2_scan(D0.expand_query(q, seq_len, seq_len),
                          jnp.asarray(db), jnp.int32(nw), jnp.int32(0),
                          seq_len, shift, 256 if wp % 256 == 0 else 64, wp)
    return np.asarray(lo), np.asarray(hi)


def _dense_count(db, q, seq_len, nw):
    dist = seq_len - (q[:, None, :] == db[None, :nw, :]).sum(axis=2)
    return (dist == dist.min(axis=1, keepdims=True)).sum(axis=1)


@pytest.mark.parametrize("seq_len", [3, 13, 60, 100])
@pytest.mark.parametrize("with_count", [True, False])
def test_min2_equals_pallas_and_xla(port, seq_len, with_count):
    nw, b = 1000, 40
    db, q, wp = _case(seq_len, nw, b, seq_len)
    got = _port(port, db, q, seq_len, nw, wp, with_count)
    shift = K.packing_shift(seq_len, wp)
    want = PS.min2_scan_pallas(
        PS.embed_query_with_one(jnp.asarray(q), seq_len),
        PS.embed_db_with_zc(jnp.asarray(db), seq_len, nw),
        seq_len, shift, tile_b=8, tile_w=256, interpret=True,
        with_count=with_count)
    assert len(got) == len(want) == (3 if with_count else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(got[:2], _xla(db, q, seq_len, nw, wp)):
        np.testing.assert_array_equal(g, w)
    if with_count:
        np.testing.assert_array_equal(got[2], _dense_count(db, q, seq_len, nw))


@pytest.mark.parametrize("seq_len,nw", [(150, 1000), (150, 64), (6, 4099)])
def test_min2_long_and_odd_windows_equal_xla(port, seq_len, nw):
    """L = 150 is past the Pallas kernel's seq_len <= 127: the port
    serves it, checked against the XLA scan and the dense count."""
    db, q, wp = _case(seq_len, nw, 24, nw)
    lo, hi, cnt = _port(port, db, q, seq_len, nw, wp, True)
    xlo, xhi = _xla(db, q, seq_len, nw, wp)
    np.testing.assert_array_equal(lo, xlo)
    np.testing.assert_array_equal(hi, xhi)
    np.testing.assert_array_equal(cnt, _dense_count(db, q, seq_len, nw))


def test_min2_cpu_never_counts_launches(port):
    port.M.launches = 0
    db, q, wp = _case(60, 200, 16, 0)
    _port(port, db, q, 60, 200, wp, True)
    assert port.M.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "device", "shift"])
def test_min2_rejects_bad_operands(port, bad):
    torch, D = port.torch, port.D
    db, q, wp = _case(13, 128, 16, 1)
    emb, zc = D.embed_db(torch.from_numpy(db), 13, wp)
    q_emb = D.expand_embed_query(torch.from_numpy(q), 13)
    shift = K.packing_shift(13, wp)
    if bad == "dtype":
        q_emb = q_emb.to(torch.int32)
    elif bad == "width":
        q_emb = q_emb[:, :32].contiguous()
    elif bad == "rows":
        emb, zc = emb[:100], zc[:100]
    elif bad == "device":
        q_emb, emb, zc = (t.to("meta") for t in (q_emb, emb, zc))
    else:
        shift = 3
    with pytest.raises((TypeError, ValueError)):
        port.M.min2(q_emb, emb, zc, 13, shift)


@pytest.mark.parametrize("b,wp", [(4096, (1 << 20) + 64), (1, (1 << 20) + 64),
                                  (16, 64), (67584, 1 << 20)])
def test_split_count_covers_the_db(port, b, wp):
    """kstats' and min_count's short-route splits over the live rows (wp
    rows of a longer buffer live, and wp - 37, a partial last block):
    at least one and never more than the live 64-row blocks, each a
    positive run of whole blocks, together every live block once and
    none past n_valid's; the plan is ``short_plan``'s over the live rows
    at each kernel's item cost, one split when the query tiles alone
    fill an H100's 132 SMs."""
    M = port.M
    for n_valid in (wp, max(1, wp - 37)):
        tiles = -(-n_valid // WP_MULTIPLE)  # live blocks
        for item in (M.KSTATS_ITEM_STEPS, M.MIN_COUNT_ITEM_STEPS):
            route, s = M.live_plan(b, n_valid, 256, 132, item)
            assert route == M.WG_ROUTE
            assert s == M.short_plan(b, tiles * WP_MULTIPLE, 132, item)
            assert 1 <= s <= tiles
            rows = [(tiles * i // s * WP_MULTIPLE,
                     tiles * (i + 1) // s * WP_MULTIPLE) for i in range(s)]
            assert rows[0][0] == 0 and rows[-1][1] == tiles * WP_MULTIPLE
            assert rows[-1][1] - WP_MULTIPLE < n_valid <= rows[-1][1]
            assert all(e0 == b1 for (_, e0), (b1, _) in zip(rows, rows[1:]))
            assert all(e > b0 and (e - b0) % WP_MULTIPLE == 0
                       for b0, e in rows)
            if -(-b // M.WG_ROWS) % 132 == 0:
                assert s == 1
