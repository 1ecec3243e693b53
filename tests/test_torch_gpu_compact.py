"""The compact_mask kernel against its plain PyTorch version on the card:
exact equality and one launch per call, on both routes.

The short route (L <= 64, the wgmma tile of csrc/wg_scan.cuh) at B = 1,
77 and 300 against 70,001 rows (S > 1 splits, which do not divide the
1,094 steps; B = 300 leaves the last query tile mostly past B) and B =
1 against 5 steps (one step per split), with thresholds that set many
bits; then every row off, every real window on, and a db of one
repeated row; tests/test_torch_gpu_compact_wg.py holds it in depth. The
K-chunked route (past 64 bp) at L = 150 and 300, at the plan's splits;
tests/test_torch_gpu_compact_long.py holds it in depth.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu


def _mask(g, q_emb, emb, zc, th, seq_len):
    """The kernel's mask, held to the plain version; one launch."""
    thresh = g.torch.from_numpy(np.asarray(th, np.int32)).to(g.dev)
    before = g.C.launches
    got = g.C.compact_mask(q_emb, emb, zc, thresh, seq_len)
    want = g.D.compact_mask_reference(q_emb, emb, zc, thresh, seq_len)
    g.torch.cuda.synchronize()
    assert g.C.launches == before + 1
    assert g.torch.equal(got, want)
    return got


def _plan(g, b, wp, ep):
    sms = g.torch.cuda.get_device_properties(g.dev).multi_processor_count
    return g.C.kernel_plan(b, wp, ep, sms)


def _row_bits(mask):
    """Set bits per row of an int32 mask, as numpy."""
    words = mask.cpu().numpy().view(np.uint32)
    return np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1)


@pytest.mark.parametrize("seq_len,nw,b", [(3, 4096, 40), (60, 70016, 300),
                                          (150, 9024, 33)])
def test_compact_kernel_equals_plain(cuda, seq_len, nw, b):
    rng = np.random.default_rng(b)
    emb, zc, q_emb, _ = operands(cuda, seq_len, nw, b, nw)
    _mask(cuda, q_emb, emb, zc, rng.integers(-1, 7, b), seq_len)


@pytest.mark.parametrize("nw,b", [(70001, 1), (70001, 77), (70001, 300),
                                  (300, 1)])
def test_compact_split_kernel_equals_plain(cuda, nw, b):
    """Thresholds mixing -1 and 0..L, which set most bits of the rows
    at 50 or more (random rows lie ~48 from a query)."""
    seq_len = 60
    rng = np.random.default_rng(nw + b)
    emb, zc, q_emb, _ = operands(cuda, seq_len, nw, b, nw + b)
    route, splits = _plan(cuda, b, emb.shape[0], q_emb.shape[1])
    assert route == cuda.M.WG_ROUTE and splits > 1
    th = rng.integers(-1, seq_len + 1, b)
    th[0] = seq_len - 10  # ~3/4 of the bits
    th[1:2] = -1
    got = _mask(cuda, q_emb, emb, zc, th, seq_len)
    assert _row_bits(got).max() > nw // 2


@pytest.mark.parametrize("kind", ["off", "all", "repeated"])
def test_compact_kernel_extreme_thresholds(cuda, kind):
    """thresh = -1 everywhere gives an all-zero mask; thresh = L sets
    every real window and no padding bit; a db of one repeated row at
    thresh = 0 sets every real window of the rows that equal it and
    nothing else."""
    torch = cuda.torch
    seq_len, nw, b = 60, 70001, 300
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
    if kind == "repeated":
        codes[:] = codes[0]
    q = codes[rng.integers(0, nw, b)].copy()
    q[1::2, :3] = (q[1::2, :3] + 1) % 5  # odd rows 3 off the db row
    wp = -(-nw // 64) * 64
    emb, zc = cuda.D.embed_db(torch.from_numpy(codes).to(cuda.dev), seq_len, wp)
    q_emb = cuda.D.expand_embed_query(torch.from_numpy(q).to(cuda.dev), seq_len)
    th = {"off": -1, "all": seq_len, "repeated": 0}[kind]
    bits = _row_bits(_mask(cuda, q_emb, emb, zc, np.full(b, th), seq_len))
    if kind == "off":
        assert (bits == 0).all()
    elif kind == "all":
        assert (bits == nw).all()
    else:
        np.testing.assert_array_equal(bits, np.where(np.arange(b) % 2, 0, nw))


@pytest.mark.parametrize("seq_len", [150, 300])
def test_compact_long_route_equals_plain(cuda, seq_len):
    """Windows past 64 bp take the long routes (form (a) at 150 bp, (b)
    at 300), with the plan's splits; thresholds mix -1 and 0..L."""
    nw, b = 4000, 77
    rng = np.random.default_rng(seq_len)
    emb, zc, q_emb, _ = operands(cuda, seq_len, nw, b, seq_len)
    route, s = _plan(cuda, b, emb.shape[0], q_emb.shape[1])
    assert route == ("wg_kchunk" if seq_len <= 160 else "wg_kchunk_stream")
    assert s == cuda.M.long_plan(b, emb.shape[0], q_emb.shape[1],
                                 cuda.M.sm_count(cuda.dev),
                                 cuda.M.COMPACT_ITEM_STEPS)[1] > 1
    got = _mask(cuda, q_emb, emb, zc, rng.integers(-1, seq_len + 1, b),
                seq_len)
    assert _row_bits(got).max() > nw // 2
