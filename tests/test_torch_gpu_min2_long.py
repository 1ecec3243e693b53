"""min2's long route (windows past 64 bp, csrc/wg_long.cuh) against its
plain PyTorch version on the card, exact.

Form (a), "wg_kchunk", the query rows resident, serves EP <= 640 (L <=
160); form (b), "wg_kchunk_stream", query and db chunks streamed, serves
longer windows. Each case runs
at one split (no merge), at the wrapper's plan and at 7 splits (a count
that divides no tile run evenly), through the library's C entry, and
once through the wrapper, which must launch once and take the plan's
route. Cases: L = 65 (three chunks of 128 bytes, the last of 32), 127,
150, 168 and 169 (past form (a)'s 160) and 300, with and without the
count;
a db of one repeated row, whose ties cross every split; 29,903 bp (935
chunks a row) on a small db (offsets past 2^31 bytes are held in
chip_smoke.py's 29,903 bp lines).

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu


def _route(ep):
    return "wg_kchunk" if ep <= 640 else "wg_kchunk_stream"


def _launch(g, q_emb, emb, zc, seq_len, shift, with_count, splits):
    """min2 through the library's C entry at ``splits`` db splits."""
    from smafa_tpu_torch.ops import _build

    torch = g.torch
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    lo = torch.full((b,), -7, dtype=torch.int32, device=g.dev)
    hi, cnt = lo.clone(), lo.clone()
    part = torch.empty((3, splits, b), dtype=torch.int32, device=g.dev)
    rc = _build.load().smafa_min2(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), cnt.data_ptr(), part.data_ptr(), b, wp, ep, seq_len,
        shift, int(with_count), splits,
        torch.cuda.current_stream(g.dev).cuda_stream)
    _build.check(rc, "min2")
    return (lo, hi, cnt) if with_count else (lo, hi)


def _held(g, q_emb, emb, zc, seq_len, shift, with_count):
    """Every split count and the wrapper equal the plain version; the
    wrapper's plan is the long route of this width."""
    torch = g.torch
    want = g.D.min2_reference(q_emb, emb, zc, seq_len, shift, with_count)
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    route, s = g.M.kernel_plan(b, wp, ep, g.M.sm_count(g.dev))
    assert route == _route(ep) and 1 <= s <= wp // WP_MULTIPLE
    for splits in sorted({1, s, min(7, wp // WP_MULTIPLE)}):
        got = _launch(g, q_emb, emb, zc, seq_len, shift, with_count, splits)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert torch.equal(a, w), splits
    before = g.M.launches
    got = g.M.min2(q_emb, emb, zc, seq_len, shift, with_count)
    torch.cuda.synchronize()
    assert g.M.launches == before + 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    return want


@pytest.mark.parametrize("seq_len", [65, 127, 150, 168, 169, 300])
@pytest.mark.parametrize("with_count", [True, False])
def test_min2_kchunk_equals_plain(cuda, seq_len, with_count):
    """9000 random rows (a tenth copies of row 3, so ties) and 300 reads
    (the second query tile mostly past B), the first 4 exact copies."""
    emb, zc, q_emb, shift = operands(cuda, seq_len, 9000, 300, seq_len)
    _held(cuda, q_emb, emb, zc, seq_len, shift, with_count)


@pytest.mark.parametrize("seq_len", [150, 300])
def test_min2_kchunk_repeated_row_db(cuda, seq_len):
    """A db of one repeated row: every split ties at the one distance, so
    lo is row 0, hi the last real row and cnt every row, summed across
    the splits by the merge."""
    torch = cuda.torch
    nw, b = 4001, 77
    rng = np.random.default_rng(seq_len)
    codes = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw, 0)
    q = codes[:b].copy()
    q[:, :5] = rng.integers(0, 5, (b, 5)).astype(np.uint8)
    wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = cuda.D.embed_db(torch.from_numpy(codes).to(cuda.dev), seq_len, wp)
    q_emb = cuda.D.expand_embed_query(torch.from_numpy(q).to(cuda.dev), seq_len)
    shift = cuda.K.packing_shift(seq_len, wp)
    lo, hi, cnt = _held(cuda, q_emb, emb, zc, seq_len, shift, True)
    assert ((lo & ((1 << shift) - 1)) == 0).all()
    assert ((hi & ((1 << shift) - 1)) == wp - nw).all()
    assert (cnt == nw).all()


def test_min2_kchunk_29903bp(cuda):
    """A SARS-CoV-2 genome's width, form (b): 637 rows in a 640-row
    buffer (a tenth copies of row 3, which the first 4 reads copy) and 40
    reads."""
    seq_len = 29903
    emb, zc, q_emb, shift = operands(cuda, seq_len, 637, 40, 1)
    assert q_emb.shape[1] == 119616
    for with_count in (True, False):
        _held(cuda, q_emb, emb, zc, seq_len, shift, with_count)
