"""The K-mode device pieces of the port against smafa_tpu on the CPU:
the kstats wrapper on CPU tensors (its plain version ``stats_reference``)
equals the XLA pass ``_statsN_pass`` it replaces, over a db buffer with
live rows past ``n_windows``; the port's cutoff search ``kmode_phase1``
equals ``kmode_stats_scan`` and the reference rule; the runner's
``_compactd`` equals ``compactd_scan``; ``sort_hit_keys`` orders as
smafa_tpu's. Exact equality: every value is an integer.

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


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import distance, kstats
    from smafa_tpu_torch.parallel.runner import ScanRunner

    return types.SimpleNamespace(torch=torch, D=distance, KS=kstats,
                                 ScanRunner=ScanRunner)


def _case(seq_len, wp, b, seed):
    """A live buffer of wp rows with planted duplicates, and queries that
    copy or mutate some of its rows (rows past any n_valid included)."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(0, wp, wp // 8)] = buf[1]
    q = buf[rng.integers(0, wp, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    q[:3] = buf[1]
    return buf, q, rng


def _port_operands(port, buf, q, seq_len):
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, buf.shape[0])
    return port.D.expand_embed_query(from_numpy(q), seq_len), emb, zc


def _dense(q, codes):
    return q.shape[1] - (q[:, None, :] == codes[None, :, :]).sum(axis=2)


def test_kstats_constants_pinned():
    assert K.KSTATS_PROBES == D0.KSTATS_PROBES
    for L in range(0, 301):
        assert K.kstats_steps(L) == D0.kstats_steps(L), L
    assert K.kstats_steps(60) == 3


@pytest.mark.parametrize("seq_len", [3, 60, 150, 161, 300])
def test_stats_reference_equals_statsN_pass(port, seq_len):
    """n_valid below the buffer's rows and not a multiple of 64: the
    rows past it are live and must not count; thresholds -1..L. 150 bp
    is the kernel's form (a) on the card, 161 (form (b)'s narrowest) and
    300 bp its form (b)."""
    wp, b = 640, 40
    buf, q, rng = _case(seq_len, wp, b, seq_len)
    q_emb, emb, zc = _port_operands(port, buf, q, seq_len)
    q_oh = D0.expand_onehot(q, seq_len)
    db_oh = D0.expand_onehot(buf, seq_len)
    for n_valid in (517, 0, wp):
        ts = rng.integers(-1, seq_len + 1, (K.KSTATS_PROBES, b)).astype(np.int32)
        cnt, mx = port.D.stats_reference(q_emb, emb, zc,
                                         port.torch.from_numpy(ts), n_valid,
                                         seq_len)
        want_cnt, want_mx = D0._statsN_pass(q_oh, db_oh, jnp.int32(n_valid),
                                            jnp.asarray(ts), seq_len, 64)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
        np.testing.assert_array_equal(mx.numpy(), np.asarray(want_mx))
        if n_valid:
            dist = _dense(q, buf[:n_valid])
            np.testing.assert_array_equal(mx.numpy(), dist.max(axis=1))
            np.testing.assert_array_equal(
                cnt.numpy(), (dist[None] <= ts[:, :, None]).sum(axis=2))
        else:
            assert (mx.numpy() == -1).all() and (cnt.numpy() == 0).all()


def test_kstats_cpu_equals_plain_and_counts_no_launch(port):
    buf, q, rng = _case(60, 256, 16, 0)
    q_emb, emb, zc = _port_operands(port, buf, q, 60)
    ts = port.torch.from_numpy(
        rng.integers(-1, 61, (K.KSTATS_PROBES, 16)).astype(np.int32))
    port.KS.launches = 0
    got = port.KS.kstats(q_emb, emb, zc, ts, 200, 60)
    want = port.D.stats_reference(q_emb, emb, zc, ts, 200, 60)
    assert port.KS.launches == 0
    for g, w in zip(got, want):
        assert port.torch.equal(g, w)


@pytest.mark.parametrize("bad", ["ts_dtype", "ts_shape", "n_valid", "device"])
def test_kstats_rejects_bad_operands(port, bad):
    torch = port.torch
    buf, q, _ = _case(13, 128, 16, 1)
    q_emb, emb, zc = _port_operands(port, buf, q, 13)
    ts = torch.zeros((K.KSTATS_PROBES, 16), dtype=torch.int32)
    n_valid = 100
    if bad == "ts_dtype":
        ts = ts.to(torch.int64)
    elif bad == "ts_shape":
        ts = ts[:3].contiguous()
    elif bad == "n_valid":
        n_valid = 129
    else:
        q_emb, emb, zc, ts = (t.to("meta") for t in (q_emb, emb, zc, ts))
    with pytest.raises((TypeError, ValueError)):
        port.KS.kstats(q_emb, emb, zc, ts, n_valid, 13)


@pytest.mark.parametrize("k", [2, 99, 1000])
def test_kmode_phase1_equals_jax(port, k):
    """K = 1000 exceeds the 700 windows: the cutoff is the row max, which
    the live rows past them (a buffer of 768) must not raise."""
    torch = port.torch
    seq_len, nw, b = 60, 700, 48
    buf, q, _ = _case(seq_len, 768, b, k)
    q[5:8] = buf[750:753]  # exact copies of rows past the real ones
    q_emb, emb, zc = _port_operands(port, buf, q, seq_len)
    q_oh = D0.expand_onehot(q, seq_len)
    db_oh = D0.expand_onehot(buf, seq_len)
    dist = _dense(q, buf[:nw])
    srt = np.sort(dist, axis=1)
    for maxdiv in (None, 0, seq_len):
        md = seq_len + 1 if maxdiv is None else maxdiv
        eff, hits = port.D.kmode_phase1(
            lambda ts: port.D.stats_reference(q_emb, emb, zc, ts, nw, seq_len),
            k, md, nw, seq_len, b, torch.device("cpu"))
        want_eff, want_hits = D0.kmode_stats_scan(
            q_oh, db_oh, jnp.int32(nw), jnp.int32(k), jnp.int32(md), seq_len, 64)
        np.testing.assert_array_equal(eff.numpy(), np.asarray(want_eff))
        np.testing.assert_array_equal(hits.numpy(), np.asarray(want_hits))
        # the reference rule (lib.rs:253-265)
        cutoff = srt[:, k - 1] if k <= nw else dist.max(axis=1)
        oracle_eff = np.minimum(cutoff, md)
        np.testing.assert_array_equal(eff.numpy(), oracle_eff)
        np.testing.assert_array_equal(
            hits.numpy(), (dist <= oracle_eff[:, None]).sum(axis=1))


@pytest.mark.parametrize("seq_len,nw", [(60, 1000), (13, 333)])
def test_compactd_equals_jax(port, seq_len, nw):
    """The runner's K-mode compaction (mask, extraction, distances from
    the codes, device sort) against ``compactd_scan`` on the same rows
    and thresholds: per-row counts and (distance, index) lists."""
    torch = port.torch
    codes, q, rng = _case(seq_len, nw, 40, nw)
    runner = port.ScanRunner(codes, seq_len, torch.device("cpu"))
    q_padded, _ = runner._pad(q)
    q_emb = runner._embed_queries(q_padded)
    row_ids = np.sort(rng.choice(40, 25, replace=False)).astype(np.int32)
    thresh = rng.integers(-1, seq_len // 3, 25).astype(np.int32)
    thresh[:3] = seq_len  # whole-db rows
    rows, idx, dv, counts = runner._compactd(q_padded, q_emb, row_ids, thresh)

    chunk = 64
    wp0 = -(-nw // chunk) * chunk
    db0 = np.zeros((wp0, seq_len), np.uint8)
    db0[:nw] = codes
    q_sel = q_padded[row_ids]
    shift0 = D0.packing_shift(seq_len, wp0)
    t_cap = 1 << int(np.ceil(np.log2(max(16, nw * 25))))
    keys, rc, total = D0.compactd_scan(
        D0.expand_query(q_sel, seq_len, seq_len), jnp.asarray(q_sel),
        jnp.asarray(db0), jnp.int32(nw), jnp.asarray(thresh), jnp.int32(0),
        seq_len, chunk, t_cap, D0._pack_mode(), shift0)
    keys = np.asarray(keys)[:int(total)]
    np.testing.assert_array_equal(counts, np.asarray(rc))
    np.testing.assert_array_equal(rows, np.repeat(row_ids, np.asarray(rc)))
    np.testing.assert_array_equal(idx, keys & ((1 << shift0) - 1))
    np.testing.assert_array_equal(dv, keys >> shift0)
    assert counts[:3].tolist() == [nw] * 3


def test_sort_hit_keys_equals_jax(port):
    torch = port.torch
    rng = np.random.default_rng(7)
    rows = np.sort(rng.integers(0, 50, 4000)).astype(np.int32)
    rng.shuffle(rows)
    keys = rng.integers(0, 2**31 - 1, 4000).astype(np.int32)
    got = port.D.sort_hit_keys(torch.from_numpy(rows.astype(np.int64)),
                               torch.from_numpy(keys))
    want = D0.sort_hit_keys(jnp.asarray(rows), jnp.asarray(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
