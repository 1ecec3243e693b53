"""min2's short route (windows up to 64 bp, the warp-specialised wgmma
tile of csrc/wg_scan.cuh) against its plain PyTorch version on the
card, exact.

Each case runs through the library's C entry at one split (no merge),
at the wrapper's plan, at 7 splits (a count that divides no step run
evenly) and at 300 (more items than a card's blocks), and once through
the wrapper, which must launch once and take the short route. Edges: L
= 1, 31, 60 and 64; batches that are not a multiple of the 256-row
query tile; Wp = 64 and Wp = 64 mod 128 (the db's trailing 64-row step
alone); padding rows (zc = -1) at distance L + 1 beside real rows at
distance L (every position a mismatch); a db of one repeated row, whose
ties cross every step and split (the merge sums them); the only exact
match in the last real row; the largest shift a 31-bit key allows; with
and without the count.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu


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
    wrapper's plan is the short route. Returns the plain version's."""
    torch = g.torch
    want = g.D.min2_reference(q_emb, emb, zc, seq_len, shift, with_count)
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    route, s = g.M.kernel_plan(b, wp, ep, g.M.sm_count(g.dev))
    assert route == g.M.WG_ROUTE and 1 <= s <= wp // WP_MULTIPLE
    tiles = wp // WP_MULTIPLE
    for splits in sorted({1, s, min(7, tiles), min(300, tiles)}):
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


def _db(g, codes, q, seq_len):
    """(db_emb, zc, q_emb, wp) of uint8 codes and queries on the card."""
    torch = g.torch
    nw = codes.shape[0]
    wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(torch.from_numpy(codes).to(g.dev), seq_len, wp)
    q_emb = g.D.expand_embed_query(torch.from_numpy(q).to(g.dev), seq_len)
    return emb, zc, q_emb, wp


@pytest.mark.parametrize("seq_len", [1, 31, 60, 64])
@pytest.mark.parametrize("with_count", [True, False])
def test_min2_wg_equals_plain(cuda, seq_len, with_count):
    """5000 random rows in 5056 (79 steps: Wp = 64 mod 128, 56 padding
    rows), a tenth copies of row 3, and 300 reads (the second query tile
    mostly past B), the first 4 exact copies of row 3."""
    emb, zc, q_emb, shift = operands(cuda, seq_len, 5000, 300, seq_len)
    assert emb.shape[0] % 128 == 64
    _held(cuda, q_emb, emb, zc, seq_len, shift, with_count)


@pytest.mark.parametrize("b", [1, 77])
def test_min2_wg_one_step_db(cuda, b):
    """Wp = 64: one step, one split; 37 real rows and 27 padding rows."""
    emb, zc, q_emb, shift = operands(cuda, 60, 37, b, b)
    assert emb.shape[0] == 64
    for with_count in (True, False):
        _held(cuda, q_emb, emb, zc, 60, shift, with_count)


def test_min2_wg_all_mismatch_beside_padding(cuda):
    """Every real row at distance L (no position matches) beside padding
    rows at L + 1: the best is L, lo row 0, hi the last real row, cnt
    every real row and no padding row."""
    seq_len, nw, b = 60, 100, 70
    codes = np.full((nw, seq_len), 2, np.uint8)
    q = np.full((b, seq_len), 1, np.uint8)
    emb, zc, q_emb, wp = _db(cuda, codes, q, seq_len)
    shift = cuda.K.packing_shift(seq_len, wp)
    lo, hi, cnt = _held(cuda, q_emb, emb, zc, seq_len, shift, True)
    assert (lo == seq_len << shift).all()
    assert (hi == (seq_len << shift) | (wp - nw)).all()
    assert (cnt == nw).all()


@pytest.mark.parametrize("nw", [70001, 70065])
def test_min2_wg_ties_across_steps_and_splits(cuda, nw):
    """A db of one repeated row (Wp = 0 and 64 mod 128): every step of
    every split ties at the one distance, so lo is row 0, hi the last
    real row and cnt every row, summed across the splits by the merge."""
    seq_len, b = 60, 77
    rng = np.random.default_rng(nw)
    codes = np.repeat(rng.integers(1, 5, (1, seq_len), dtype=np.uint8), nw, 0)
    q = codes[:b].copy()
    q[:, :5] = rng.integers(0, 5, (b, 5)).astype(np.uint8)
    emb, zc, q_emb, wp = _db(cuda, codes, q, seq_len)
    shift = cuda.K.packing_shift(seq_len, wp)
    lo, hi, cnt = _held(cuda, q_emb, emb, zc, seq_len, shift, True)
    assert ((lo & ((1 << shift) - 1)) == 0).all()
    assert ((hi & ((1 << shift) - 1)) == wp - nw).all()
    assert (cnt == nw).all()


@pytest.mark.parametrize("seq_len", [60, 64])
def test_min2_wg_largest_shift(cuda, seq_len):
    """The largest shift a 31-bit key allows at this width (25 at 60 bp,
    24 at 64), far past the index bits the db needs."""
    emb, zc, q_emb, _ = operands(cuda, seq_len, 9000, 513, seq_len + 1)
    shift = 31 - int(np.ceil(np.log2(seq_len + 2)))
    assert (seq_len + 1) << shift < 2**31 <= (seq_len + 1) << (shift + 1)
    for with_count in (True, False):
        _held(cuda, q_emb, emb, zc, seq_len, shift, with_count)


def test_min2_wg_best_in_the_last_row(cuda):
    """The reads' only exact match is the db's last real row, in the last
    step of the last split: lo and hi both name it."""
    seq_len, nw, b = 60, 70001, 77
    rng = np.random.default_rng(5)
    codes = rng.integers(1, 5, (nw, seq_len), dtype=np.uint8)
    q = np.repeat(codes[-1:], b, 0)
    q[b // 2:, :3] = rng.integers(1, 5, (b - b // 2, 3)).astype(np.uint8)
    q[: b // 2] = codes[-1]
    emb, zc, q_emb, wp = _db(cuda, codes, q, seq_len)
    shift = cuda.K.packing_shift(seq_len, wp)
    lo, hi, _ = _held(cuda, q_emb, emb, zc, seq_len, shift, True)
    exact = slice(0, b // 2)
    assert (lo[exact] == nw - 1).all() and (hi[exact] == wp - nw).all()
