"""The min2 kernel against its plain PyTorch version on the card, exact.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("seq_len,nw,b", [(3, 5000, 77), (60, 70001, 300),
                                          (60, 64, 1), (150, 9000, 129),
                                          (300, 4000, 40)])
@pytest.mark.parametrize("with_count", [True, False])
def test_min2_kernel_equals_plain(cuda, seq_len, nw, b, with_count):
    """L = 150 and 300 take the K-chunked route, forms (a) and (b)."""
    emb, zc, q_emb, shift = operands(cuda, seq_len, nw, b, nw)
    before = cuda.M.launches
    got = cuda.M.min2(q_emb, emb, zc, seq_len, shift, with_count)
    want = cuda.D.min2_reference(q_emb, emb, zc, seq_len, shift, with_count)
    cuda.torch.cuda.synchronize()
    assert cuda.M.launches == before + 1
    for a, w in zip(got, want):
        assert cuda.torch.equal(a, w)


@pytest.mark.parametrize("db_kind,b", [("random", 1), ("random", 77),
                                       ("identical", 77), ("last_row", 77)])
@pytest.mark.parametrize("with_count", [True, False])
def test_min2_split_kernel_equals_plain(cuda, db_kind, b, with_count):
    """The short route's db splits (B = 1 and 77 give 132 splits of
    70,001 rows, a step count S does not divide) and the exact path of
    the max-first epilogue: a db of one repeated row (every step reaches
    the running best; cnt = 70,001), and one whose only exact match of
    the queries is its last real row."""
    torch = cuda.torch
    seq_len, nw = 60, 70001
    rng = np.random.default_rng(b)
    codes = rng.integers(1, 5, (nw, seq_len), dtype=np.uint8)
    if db_kind == "identical":
        codes[:] = codes[0]
    q = codes[rng.integers(0, nw, b)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    if db_kind == "last_row":
        q[:] = codes[-1]
    wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = cuda.D.embed_db(torch.from_numpy(codes).to(cuda.dev), seq_len, wp)
    q_emb = cuda.D.expand_embed_query(torch.from_numpy(q).to(cuda.dev), seq_len)
    shift = cuda.K.packing_shift(seq_len, wp)
    sms = torch.cuda.get_device_properties(cuda.dev).multi_processor_count
    assert cuda.M.kernel_plan(b, wp, q_emb.shape[1], sms)[1] > 1
    got = cuda.M.min2(q_emb, emb, zc, seq_len, shift, with_count)
    want = cuda.D.min2_reference(q_emb, emb, zc, seq_len, shift, with_count)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    if db_kind == "identical" and with_count:
        assert (got[2] == nw).all()
    if db_kind == "last_row":
        assert (got[0] == nw - 1).all() and (got[1] == wp - nw).all()
