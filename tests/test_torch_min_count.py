"""The min_count wrapper on CPU tensors (its plain version) equals the
Pallas kernel it replaces (``min_count_scan``, interpret mode) and the
XLA ``min_scan`` the JAX cluster op runs, with the db buffer holding
live rows past ``n_valid``. Exact equality: every value is an integer.

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


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import distance, min_count

    return types.SimpleNamespace(torch=torch, D=distance, M=min_count)


def _operands(port, buf, seq_len):
    """Port operands over a whole uint8 [wp, L] buffer (every row live)."""
    from_numpy = port.torch.from_numpy
    emb, zc = port.D.embed_db(from_numpy(buf), seq_len, buf.shape[0])
    return emb, zc


def _port(port, q, emb, zc, n_valid, seq_len, shift, with_count=True):
    q_emb = port.D.expand_embed_query(port.torch.from_numpy(q), seq_len)
    out = port.M.min_count(q_emb, emb, zc, n_valid, seq_len, shift,
                           with_count)
    dist, idx = port.D.unpack_min_key(out[0], shift)
    return [t.numpy() for t in (dist, idx, *out[1:])]


def _pallas(db, q, seq_len, tb=8, tw=128):
    """test_pallas_scan._run: the Pallas kernel in interpret mode."""
    W, B = db.shape[0], q.shape[0]
    db_oh = np.asarray(D0.expand_onehot(db, seq_len))
    q_oh = np.asarray(D0.expand_onehot(q, seq_len))
    bp = ((B + tb - 1) // tb) * tb
    wp = ((W + tw - 1) // tw) * tw
    q_p = np.pad(q_oh, [(0, bp - B), (0, 0)])
    db_p = np.pad(db_oh, [(0, wp - W), (0, 0)])
    shift = PS.packing_shift(seq_len, wp)
    d, i, c = PS.min_count_scan(
        jnp.asarray(q_p), jnp.asarray(db_p), jnp.asarray([W], jnp.int32),
        seq_len, shift, tb, tw, interpret=True)
    return [np.asarray(x)[:B] for x in (d, i, c)], shift


def _case(seq_len, W, B, seed):
    """tests/test_pallas_scan.py:test_min_count_parity's inputs."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 5, size=(W, seq_len)).astype(np.uint8)
    q = rng.integers(0, 5, size=(B, seq_len)).astype(np.uint8)
    k = min(5, W, B)
    q[:k] = db[:k]
    if W > 3:
        db[W - 1] = db[0]
        db[W - 2] = db[0]
    return db, q


@pytest.mark.parametrize("seq_len,W,B,seed", [(60, 300, 70, 0), (13, 97, 33, 1),
                                              (3, 5, 9, 2), (150, 200, 20, 3),
                                              (161, 200, 20, 5),
                                              (300, 200, 20, 4)])
@pytest.mark.parametrize("with_count", [True, False])
def test_min_count_equals_pallas(port, seq_len, W, B, seed, with_count):
    db, q = _case(seq_len, W, B, seed)
    want, shift = _pallas(db, q, seq_len)
    wp = -(-W // WP_MULTIPLE) * WP_MULTIPLE
    buf = np.zeros((wp, seq_len), np.uint8)
    buf[:W] = db
    emb, zc = _operands(port, buf, seq_len)
    got = _port(port, q, emb, zc, W, seq_len, shift, with_count)
    assert len(got) == (3 if with_count else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seq_len,n_valid", [(60, 1000), (60, 64), (60, 1),
                                             (60, 0), (13, 777), (150, 300),
                                             (161, 517), (300, 300)])
def test_min_count_equals_min_scan(port, seq_len, n_valid):
    """A centroid buffer whose rows past n_valid are live codes (better
    matches than any real row): the scan must not see them. n_valid = 0
    gives min_count_scan's sentinels and a zero count."""
    rng = np.random.default_rng(n_valid)
    wp = 1024
    buf = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    q = rng.integers(0, 5, (48, seq_len), dtype=np.uint8)
    q[:8] = buf[n_valid:n_valid + 8] if n_valid + 8 <= wp else q[:8]
    q[8:11] = buf[0]
    buf[n_valid // 2] = buf[0]  # a tie: the lower index wins
    shift = K.packing_shift(seq_len, wp)
    assert shift == D0.packing_shift(seq_len, wp)
    emb, zc = _operands(port, buf, seq_len)
    dist, idx, cnt = _port(port, q, emb, zc, n_valid, seq_len, shift)
    if n_valid == 0:
        # min_count_scan's sentinels; min_scan, which the cluster op never
        # calls without a centroid, returns L + 1 and 0 instead
        assert (dist == 2**30).all() and (idx == 2**31 - 1).all()
        assert (cnt == 0).all()
        return
    d, i = D0.min_scan(D0.expand_query(q, seq_len, seq_len),
                       jnp.asarray(buf), jnp.int32(n_valid), seq_len, 256)
    np.testing.assert_array_equal(dist, np.asarray(d))
    np.testing.assert_array_equal(idx, np.asarray(i))
    full = seq_len - (q[:, None, :] == buf[None, :n_valid, :]).sum(axis=2)
    np.testing.assert_array_equal(cnt, (full == full.min(axis=1, keepdims=True)).sum(axis=1))
