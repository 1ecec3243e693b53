"""The compact_mask wrapper on CPU tensors (its plain version) equals the
Pallas compaction mask (interpret mode) bit for bit, and the port's
extraction equals smafa_tpu.ops.distance.extract_mask_hits.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest

from smafa_tpu.ops import distance as D0
from smafa_tpu.ops import pallas_scan as PS

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import compact, distance

    return types.SimpleNamespace(torch=torch, D=distance, C=compact)


def _case(seq_len, nw, b, seed):
    rng = np.random.default_rng(seed)
    wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
    db = rng.integers(0, 3, (wp, seq_len), dtype=np.uint8)
    db[nw:] = 0
    db[nw // 4:nw // 2] = db[:nw // 2 - nw // 4]  # duplicates
    q = db[rng.integers(0, nw, b)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    th = rng.integers(0, 7, b).astype(np.int32)
    th[1] = -1   # disabled row
    th[2] = 0    # exact-match-only row
    return db, q, th, wp


def _port_mask(port, db, q, th, seq_len, nw, wp):
    D, from_numpy = port.D, port.torch.from_numpy
    emb, zc = D.embed_db(from_numpy(db[:nw]), seq_len, wp)
    q_emb = D.expand_embed_query(from_numpy(q), seq_len)
    return port.C.compact_mask(q_emb, emb, zc, from_numpy(th), seq_len)


@pytest.mark.parametrize("seq_len,nw", [(60, 2048), (60, 2011), (13, 1000),
                                        (3, 512), (100, 1024), (300, 1024)])
def test_mask_equals_pallas(port, seq_len, nw):
    """compact_mask_pallas takes windows up to 127 bp
    (pallas_scan.py:embed_db_with_zc); smafa_tpu builds the mask of
    longer ones (300 bp here) with its XLA fold, mask_fold_chunk, which
    is then the reference."""
    b = 48
    db, q, th, wp = _case(seq_len, nw, b, nw)
    got = _port_mask(port, db, q, th, seq_len, nw, wp).numpy()
    if seq_len <= 127:
        want = np.asarray(PS.compact_mask_pallas(
            PS.embed_query_with_one(jnp.asarray(q), seq_len),
            PS.embed_db_with_zc(jnp.asarray(db), seq_len, nw),
            jnp.asarray(th), seq_len, tile_b=16,
            tile_w=512 if wp % 512 == 0 else wp, interpret=True))
    else:
        dist = D0.pairwise_distances(D0.expand_onehot(q, seq_len),
                                     D0.expand_onehot(db, seq_len), seq_len)
        want = np.asarray(D0.mask_fold_chunk(
            jnp.zeros((b, wp // 32), jnp.uint32), dist,
            jnp.arange(wp, dtype=jnp.int32), nw, jnp.asarray(th), 0,
            "reduce"))
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("seq_len", [60, 150])
def test_mask_equals_dense_oracle(port, seq_len):
    db, q, th, wp = _case(seq_len, 700, 32, 3)
    mask = _port_mask(port, db, q, th, seq_len, 700, wp).numpy().view(np.uint32)
    dist = seq_len - (q[:, None, :] == db[None, :700, :]).sum(axis=2)
    hit = np.zeros((32, wp), bool)
    hit[:, :700] = dist <= th[:, None]
    bits = (mask[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits.reshape(32, wp).astype(bool), hit)


@pytest.mark.parametrize("density", [0.0, 0.001, 0.05, 0.5, 1.0])
def test_extraction_equals_xla(port, density):
    rng = np.random.default_rng(int(density * 1000))
    b, w32 = 24, 64
    bits = rng.random((b, w32 * 32)) < density
    bits[3] = False                      # empty row
    bits[5, -1] = True                   # bit 31 of the last word
    words = np.packbits(bits.reshape(b, w32, 32)[:, :, ::-1], axis=2,
                        bitorder="big").view(">u4")[..., 0].astype(np.uint32)
    rows, idx, counts = port.D.extract_mask_hits(
        port.torch.from_numpy(words.view(np.int32)))
    t_cap = max(16, int(bits.sum()))
    wr, wi, wc, wt = D0.extract_mask_hits(jnp.asarray(words), jnp.int32(0),
                                          w32 * 32, t_cap)
    wr, wi = np.asarray(wr), np.asarray(wi)
    keep = wr >= 0
    np.testing.assert_array_equal(rows.numpy(), wr[keep])
    np.testing.assert_array_equal(idx.numpy(), wi[keep])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))
    assert int(counts.sum()) == int(wt) == int(bits.sum())


def test_compact_cpu_never_counts_launches(port):
    port.C.launches = 0
    db, q, th, wp = _case(60, 256, 16, 0)
    _port_mask(port, db, q, th, 60, 256, wp)
    assert port.C.launches == 0


@pytest.mark.parametrize("bad", ["thresh_dtype", "thresh_len", "device"])
def test_compact_rejects_bad_operands(port, bad):
    torch, D = port.torch, port.D
    db, q, th, wp = _case(13, 128, 16, 1)
    emb, zc = D.embed_db(torch.from_numpy(db), 13, wp)
    q_emb = D.expand_embed_query(torch.from_numpy(q), 13)
    thresh = torch.from_numpy(th)
    if bad == "thresh_dtype":
        thresh = thresh.to(torch.int64)
    elif bad == "thresh_len":
        thresh = thresh[:3]
    else:
        q_emb, emb, zc, thresh = (t.to("meta") for t in (q_emb, emb, zc, thresh))
    with pytest.raises((TypeError, ValueError)):
        port.C.compact_mask(q_emb, emb, zc, thresh, 13)
