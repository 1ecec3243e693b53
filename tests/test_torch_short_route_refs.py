"""The plain versions of kstats and min_count against smafa_tpu's, on
the CPU, at the widths around the short route's boundaries (the wgmma
tile of csrc/wg_scan.cuh, L <= 64): 32 / 33 bp, where a row's embedding
takes one 128-byte panel or two, 31 beside it, 63 bp, the widest whose
scores fit kstats' byte lanes, and 64 bp, the route's widest, counted in
16-bit pairs; 3 bp, where chance matches tie. ``stats_reference``
against ``_statsN_pass``, ``min_count_reference`` against
``min_count_scan`` in interpret mode, exactly, over buffers whose rows
past n_valid are live (tests/test_torch_kstats_split.py and
tests/test_torch_min_count_split.py, whose cases these reuse, hold the
splits' merge).

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.ops import distance as D0
from smafa_tpu_torch.ops import keys as K
from test_torch_kstats_split import _case as _kstats_case
from test_torch_min_count_split import _case as _min_count_case
from test_torch_min_count_split import _pallas as _min_count_scan

H100_SMS = 132


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import distance, min2

    return types.SimpleNamespace(torch=torch, D=distance, M=min2)


def _kstats_plan(port, b, n_valid, ep, sms):
    return port.M.live_plan(b, n_valid, ep, sms, port.M.KSTATS_ITEM_STEPS)


def _min_count_plan(port, b, n_valid, ep, sms):
    return port.M.live_plan(b, n_valid, ep, sms, port.M.MIN_COUNT_ITEM_STEPS)


@pytest.mark.parametrize("seq_len", [3, 31, 32, 33, 63, 64])
def test_stats_reference_equals_statsN_pass_at_the_boundaries(port, seq_len):
    """The plain version against ``_statsN_pass`` at the short route's
    panel boundary (32 / 33 bp: one 128-byte panel or two) and its byte
    lanes' (63 bp, the widest whose scores stay below 64, and 64 bp, in
    pairs): n_valid = 517 of a 704-row buffer whose rows past it are
    live and farther than every real row, thresholds from -1 to L."""
    wp, b, n_valid = 704, 48, 517
    buf, q, ts_np = _kstats_case(seq_len, wp, b, n_valid, seq_len, far=True)
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, wp)
    q_emb = port.D.expand_embed_query(from_numpy(q), seq_len)
    ep = port.D.embed_width(seq_len)
    assert ep == q_emb.shape[1] <= port.M.SPLIT_EP_MAX
    assert (ep <= 128) == (seq_len <= 32)
    assert _kstats_plan(port, b, n_valid, ep, H100_SMS)[0] == "wgmma"
    cnt, mx = port.D.stats_reference(q_emb, emb, zc, from_numpy(ts_np),
                                     n_valid, seq_len)
    want_cnt, want_mx = D0._statsN_pass(
        D0.expand_onehot(q, seq_len), D0.expand_onehot(buf, seq_len),
        jnp.int32(n_valid), jnp.asarray(ts_np), seq_len, 64)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(want_mx))


@pytest.mark.parametrize("seq_len", [3, 31, 32, 33, 63, 64])
def test_min_count_reference_equals_min_count_scan_at_the_boundaries(
        port, seq_len):
    """The plain version against ``min_count_scan`` in interpret mode at
    the short route's panel boundary (32 / 33 bp: one 128-byte panel or
    two), next to it (31) and at its widest windows (63, 64): n_valid =
    517 of a 640-row live buffer with a 4-way tie over the partial
    block and live copies of reads past n_valid, with and without the
    count."""
    wp, b, n_valid = 640, 40, 517
    buf, q = _min_count_case(seq_len, wp, b, n_valid, seq_len)
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, wp)
    q_emb = port.D.expand_embed_query(from_numpy(q), seq_len)
    ep = port.D.embed_width(seq_len)
    assert (ep <= 128) == (seq_len <= 32) and ep <= port.M.SPLIT_EP_MAX
    assert _min_count_plan(port, b, n_valid, ep, H100_SMS)[0] == "wgmma"
    shift = K.packing_shift(seq_len, wp)
    want = _min_count_scan(buf, q, n_valid, seq_len)
    for with_count in (True, False):
        got = port.D.min_count_reference(q_emb, emb, zc, n_valid, seq_len,
                                         shift, with_count)
        dist, idx = (t.numpy() for t in port.D.unpack_min_key(got[0], shift))
        np.testing.assert_array_equal(dist, want[0])
        np.testing.assert_array_equal(idx, want[1])
        if with_count:
            np.testing.assert_array_equal(got[1].numpy(), want[2])
