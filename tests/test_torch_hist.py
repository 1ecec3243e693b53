"""The K-mode histogram pieces of the port against smafa_tpu on the CPU:
the hist wrapper on CPU tensors (its plain version ``hist_reference``)
equals the XLA program ``hist_scan`` it replaces, over a db buffer with
live rows past ``n_valid``; the port's ``kmode_cutoffs_from_hist`` (in
torch) equals smafa_tpu's numpy rule on random and adversarial
histograms, and under the caps ``kmode_stats_async`` puts on K and the
divergence; the kernel's launch plan. Exact equality: every value is an
integer.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.ops import distance as D0
from smafa_tpu_torch.ops import keys as K


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import distance, hist, min2

    return types.SimpleNamespace(torch=torch, D=distance, H=hist, M=min2)


def _case(seq_len, wp, b, seed, repeated=False):
    """A live buffer of wp rows with planted duplicates (every row the
    same one when ``repeated``), and queries that copy or mutate some of
    its rows, rows past any n_valid included."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(0, wp, wp // 8)] = buf[1]
    if repeated:
        buf[:] = buf[1]
    q = buf[rng.integers(0, wp, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    q[:3] = buf[1]
    q[3] = buf[-1]
    return buf, q


def _port_operands(port, buf, q, seq_len):
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, buf.shape[0])
    return port.D.expand_embed_query(from_numpy(q), seq_len), emb, zc


def _dense(q, codes):
    return q.shape[1] - (q[:, None, :] == codes[None, :, :]).sum(axis=2)


def test_hist_max_pinned():
    assert K.HIST_MAX == D0.HIST_MAX == 1024


@pytest.mark.parametrize("seq_len", [3, 24, 60, 63, 64, 65, 127, 150, 300,
                                     1023])
def test_hist_reference_equals_hist_scan(port, seq_len):
    """n_valid below the buffer's rows (not a multiple of 64: the rows
    past it are live and must not count) and at them; at 60 bp also a db
    of one repeated row (every row in one bin)."""
    wp, b = 192, 24
    for repeated in ((False, True) if seq_len == 60 else (False,)):
        buf, q = _case(seq_len, wp, b, seq_len, repeated)
        q_emb, emb, zc = _port_operands(port, buf, q, seq_len)
        q_oh = D0.expand_onehot(q, seq_len)
        db_oh = D0.expand_onehot(buf, seq_len)
        for n_valid in (131, wp):
            got = port.H.hist(q_emb, emb, zc, n_valid, seq_len).numpy()
            want = np.asarray(D0.hist_scan(q_oh, db_oh, jnp.int32(n_valid),
                                           seq_len, 64))
            np.testing.assert_array_equal(got, want)
            dist = _dense(q, buf[:n_valid])
            np.testing.assert_array_equal(
                got, (dist[:, :, None] == np.arange(seq_len + 1)).sum(axis=1))
            if repeated:
                assert (got.max(axis=1) == n_valid).all()


def test_hist_cpu_counts_no_launch_and_empty(port):
    buf, q = _case(60, 128, 16, 0)
    q_emb, emb, zc = _port_operands(port, buf, q, 60)
    port.H.launches = 0
    got = port.H.hist(q_emb, emb, zc, 0, 60)
    assert port.H.launches == 0
    assert tuple(got.shape) == (16, 61) and int(got.abs().sum()) == 0
    assert got.dtype == port.torch.int32


@pytest.mark.parametrize("bad", ["n_valid", "long_window", "device"])
def test_hist_rejects_bad_operands(port, bad):
    L = 1024 if bad == "long_window" else 13
    buf, q = _case(L, 64, 16, 1)
    q_emb, emb, zc = _port_operands(port, buf, q, L)
    n_valid = 65 if bad == "n_valid" else 50
    if bad == "device":
        q_emb, emb, zc = (t.to("meta") for t in (q_emb, emb, zc))
    with pytest.raises((TypeError, ValueError)):
        port.H.hist(q_emb, emb, zc, n_valid, L)


def test_launch_plan_routes(port):
    """The route follows the embedding width (the scans' short route's
    width up to SPLIT_EP_MAX, and hist's own RESIDENT_EP_MAX); a block's bins
    (16-bit copies a lane on the split route, a lane pair to 168 bp, one
    odd-strided row of two-bin words past it) and ring fit the card's
    232,448 shared bytes;
    the splits make the items fill 132 SMs exactly at 4096 reads and
    never pass the db steps."""
    for seq_len, route, rows in (
            (3, "split", 128), (60, "split", 128), (64, "split", 128),
            (65, "kchunk", 128), (168, "kchunk", 128),
            (169, "kchunk_stream", 64), (1023, "kchunk_stream", 64)):
        plan = port.H.launch_plan(4096, (1 << 20) + 37, seq_len, 132)
        ep = port.D.embed_width(seq_len)
        assert plan.route == route
        assert (route == "split") == (ep <= port.M.SPLIT_EP_MAX)
        assert (route == "kchunk_stream") == (ep > port.H.RESIDENT_EP_MAX)
        if route == "split":  # the widths of the scans' short route
            assert port.M.live_plan(4096, 1 << 20, ep, 132,
                                    port.M.KSTATS_ITEM_STEPS)[0] == "wgmma"
        want_bins = (8 * (seq_len + 1) * 32 * 4 if route == "split"
                     else 8 * (seq_len + 1) * 16 * 4 if route == "kchunk"
                     else rows * (((seq_len + 2) // 2) | 1) * 4)
        assert (plan.block_rows, plan.bin_bytes) == (rows, want_bins)
        assert plan.smem_bytes <= 232_448 and plan.stages >= 2
        assert plan.splits == 33 and (4096 // rows * 33) % 132 == 0
        assert plan.grid == 132
        assert port.H.launch_plan(1, 37, seq_len, 132).splits == 1
        step = {"split": 128, "kchunk": 128, "kchunk_stream": 256}[route]
        assert port.H.launch_plan(1, 10 * step, seq_len, 132).splits == 10
        assert port.H.launch_plan(1, 10 * step + 1, seq_len,
                                  132).splits == 11
        assert port.H.launch_plan(0, 37, seq_len, 132).splits == 0


def _cutoffs_both(port, hist, k, maxdiv, n_windows):
    want = D0.kmode_cutoffs_from_hist(hist, k, maxdiv, n_windows)
    got = port.D.kmode_cutoffs_from_hist(
        port.torch.from_numpy(hist), k, maxdiv, n_windows)
    for g, w in zip(got, want):
        assert g.dtype == port.torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    return got


def _adversarial_hists(seq_len, rng):
    """Rows of one bin, of the first or last bin only, with empty
    leading and trailing bins, with a tie block at one bin, and an
    empty row (numpy's argmax then gives the last bin)."""
    h = np.zeros((7, seq_len + 1), np.int32)
    h[0, seq_len // 2] = 9
    h[1, 0] = 9
    h[2, seq_len] = 9
    h[3, 2:seq_len - 1] = rng.integers(0, 3, seq_len - 3)
    h[3, 2] += 1
    h[4, 1] = 4
    h[4, 3] = 5
    h[5, [0, seq_len]] = [3, 6]
    return h  # row 6 empty


@pytest.mark.parametrize("seq_len", [3, 60, 150])
def test_cutoffs_from_hist_equal_smafa_tpu(port, seq_len):
    """Random histograms of 40 windows a row and adversarial ones, at K
    from 1 to past the window count, the divergence None, 0, L and past
    it: the cutoff at a tie, empty leading and trailing bins."""
    rng = np.random.default_rng(seq_len)
    n = 40
    rand = np.stack([np.bincount(rng.integers(0, seq_len + 1, n),
                                 minlength=seq_len + 1)
                     for _ in range(30)]).astype(np.int32)
    for h in (rand, _adversarial_hists(seq_len, rng)):
        for k in (1, 4, 5, 9, n - 1, n, n + 1, 1000):
            for maxdiv in (None, 0, 1, seq_len, seq_len + 1, 2**32 - 1):
                _cutoffs_both(port, h, k, maxdiv, n)


def test_cutoffs_under_the_ports_caps(port):
    """kmode_stats_async caps K at n_windows + 1 and the divergence at
    L + 1 (None as L + 1): the rule gives smafa_tpu's values at the
    uncapped ones."""
    seq_len, n = 60, 500
    rng = np.random.default_rng(3)
    h = np.stack([np.bincount(rng.integers(20, 50, n),
                              minlength=seq_len + 1)
                  for _ in range(16)]).astype(np.int32)
    for k in (1, 99, n, n + 1, n + 2, 2**32 - 1):
        for maxdiv in (None, 0, 30, seq_len, seq_len + 1, 2**32 - 1):
            want = D0.kmode_cutoffs_from_hist(h, k, maxdiv, n)
            capped = seq_len + 1 if maxdiv is None else min(seq_len + 1,
                                                            maxdiv)
            got = port.D.kmode_cutoffs_from_hist(
                port.torch.from_numpy(h), min(k, n + 1), capped, n)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)


def test_cutoffs_equal_kmode_phase1(port):
    """One histogram pass gives the cutoffs and hit counts of the whole
    kstats search (``kmode_phase1`` over ``stats_reference``) on the same
    operands, live rows past n_windows included."""
    torch = port.torch
    seq_len, wp, n = 60, 768, 700
    buf, q = _case(seq_len, wp, 48, 5)
    q[5:8] = buf[750:753]  # exact copies of rows past the real ones
    q_emb, emb, zc = _port_operands(port, buf, q, seq_len)
    h = port.D.hist_reference(q_emb, emb, zc, n, seq_len)
    for k in (1, 2, 99, n, n + 1):
        for md in (0, 3, seq_len, seq_len + 1):
            want = port.D.kmode_phase1(
                lambda ts: port.D.stats_reference(q_emb, emb, zc, ts, n,
                                                  seq_len),
                k, md, n, seq_len, q_emb.shape[0], torch.device("cpu"))
            got = port.D.kmode_cutoffs_from_hist(h, k, md, n)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (k, md)
