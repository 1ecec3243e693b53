"""min2's and compact_mask's long routes (windows past 64 bp) on the
K-chunked wgmma tile (csrc/wg_long.cuh) against their plain PyTorch
versions on the card, bit for bit.

Form (a), "wg_kchunk", the block's query rows resident, serves EP <= 640
(L <= 160); form (b), "wg_kchunk_stream", query and db chunks streamed
in steps of 128 db rows, serves wider rows (its last step may pass the
db, a multiple of 64 rows). Each case runs through the library's C
entry at 1 db split, at the plan's, at 7 and at W / 64 (more splits
than form (b) has steps: the surplus walk nothing and write empty
partials), min2 with and without the count and through the merge, and
compact_mask into a mask filled with a sentinel (a word no block writes
shows); then once through each wrapper, which must launch once and take
the plan's route. Cases: L = 65, 127, 150, 160 (form (a)'s widest), 161
(the next), 168, 300, 1023 and 29,903; B = 1, 33, 257 and 4097 in both
forms; thresholds off and all; a db a tenth of whose rows copy one row
(ties at every step: every db here) and a db of one repeated row.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu

SENTINEL = 0x5A5A5A5A


def _route(ep):
    return "wg_kchunk" if ep <= 640 else "wg_kchunk_stream"


def _splits(g, b, wp, ep, plan):
    """The split counts each case runs at through the C entry."""
    assert plan[0] == _route(ep) and 1 <= plan[1] <= wp // WP_MULTIPLE
    return sorted({1, plan[1], min(7, wp // WP_MULTIPLE), wp // WP_MULTIPLE})


def _min2_c(g, q_emb, emb, zc, seq_len, shift, with_count, splits):
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


def _compact_c(g, q_emb, emb, zc, thresh, seq_len, splits):
    from smafa_tpu_torch.ops import _build

    torch = g.torch
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    mask = torch.full((b, wp // 32), SENTINEL, dtype=torch.int32,
                      device=g.dev)
    rc = _build.load().smafa_compact_mask(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), thresh.data_ptr(),
        mask.data_ptr(), b, wp, ep, seq_len, splits,
        torch.cuda.current_stream(g.dev).cuda_stream)
    _build.check(rc, "compact_mask")
    return mask


def held_min2(g, q_emb, emb, zc, seq_len, shift):
    """min2 with and without the count at every split count and through
    the wrapper equals the plain version; returns (lo, hi, cnt)."""
    torch = g.torch
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    plan = g.M.kernel_plan(b, wp, ep, g.M.sm_count(g.dev))
    out = None
    for with_count in (True, False):
        want = g.D.min2_reference(q_emb, emb, zc, seq_len, shift, with_count)
        if with_count:
            out = want
        for s in _splits(g, b, wp, ep, plan):
            got = _min2_c(g, q_emb, emb, zc, seq_len, shift, with_count, s)
            torch.cuda.synchronize()
            for a, w in zip(got, want):
                assert torch.equal(a, w), (with_count, s)
        before = g.M.launches
        got = g.M.min2(q_emb, emb, zc, seq_len, shift, with_count)
        torch.cuda.synchronize()
        assert g.M.launches == before + 1
        for a, w in zip(got, want):
            assert torch.equal(a, w), with_count
    return out


def held_compact(g, q_emb, emb, zc, th, seq_len):
    """compact_mask at every split count and through the wrapper equals
    the plain version; returns each row's set bits, as numpy."""
    torch = g.torch
    thresh = torch.from_numpy(np.asarray(th, np.int32)).to(g.dev)
    want = g.D.compact_mask_reference(q_emb, emb, zc, thresh, seq_len)
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    plan = g.C.kernel_plan(b, wp, ep, g.M.sm_count(g.dev))
    for s in _splits(g, b, wp, ep, plan):
        got = _compact_c(g, q_emb, emb, zc, thresh, seq_len, s)
        torch.cuda.synchronize()
        assert torch.equal(got, want), s
    before = g.C.launches
    got = g.C.compact_mask(q_emb, emb, zc, thresh, seq_len)
    torch.cuda.synchronize()
    assert g.C.launches == before + 1
    assert torch.equal(got, want)
    words = want.cpu().numpy().view(np.uint32)
    return np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1)


@pytest.mark.parametrize("seq_len,nw,b", [
    (65, 5000, 300), (127, 5000, 300), (150, 5000, 300), (160, 5000, 300),
    (161, 5000, 300), (168, 5000, 300), (300, 4001, 300), (1023, 2000, 300),
    (29903, 637, 260)])
def test_long_routes_equal_plain(cuda, seq_len, nw, b):
    """Random rows over codes 0-4 (a tenth copies of row 3, which the
    first 4 reads copy: ties at every step) and reads mutated off them;
    min2 and compact_mask at thresholds in [-1, L], the first 8 rows at L
    (every real window) and the next 8 at -1 (none); db rows 5,056,
    4,032 (form (b)'s last step half past the db), 2,048 and 640."""
    emb, zc, q_emb, shift = operands(cuda, seq_len, nw, b, seq_len)
    held_min2(cuda, q_emb, emb, zc, seq_len, shift)
    th = np.random.default_rng(seq_len).integers(-1, seq_len + 1, b)
    th[:8], th[8:16] = seq_len, -1
    bits = held_compact(cuda, q_emb, emb, zc, th, seq_len)
    assert (bits[:8] == nw).all() and (bits[8:16] == 0).all()


@pytest.mark.parametrize("b", [1, 33, 257, 4097])
def test_long_routes_batches(cuda, b):
    """Batches below the 256-row block, one row past it and 4097 (17
    query tiles, the last of one row), in both forms (150 and 300 bp)."""
    for seq_len in (150, 300):
        emb, zc, q_emb, shift = operands(cuda, seq_len, 3000, b, b + seq_len)
        held_min2(cuda, q_emb, emb, zc, seq_len, shift)
        th = np.random.default_rng(b).integers(-1, seq_len // 3, b)
        th[0] = seq_len // 2
        assert held_compact(cuda, q_emb, emb, zc, th, seq_len)[0] > 0


@pytest.mark.parametrize("kind", ["off", "all"])
def test_long_routes_extreme_thresholds(cuda, kind):
    """thresh = -1 everywhere sets no bit; thresh = L sets every real
    window and no padding row; in both forms."""
    for seq_len in (150, 300):
        emb, zc, q_emb, _ = operands(cuda, seq_len, 3001, 77, seq_len + 1)
        bits = held_compact(cuda, q_emb, emb, zc,
                            np.full(77, -1 if kind == "off" else seq_len),
                            seq_len)
        assert (bits == (0 if kind == "off" else 3001)).all()


def test_long_routes_repeated_row_db(cuda):
    """A db of one repeated row: every step and every split ties at the
    one distance, so lo is row 0, hi the last real row and cnt every row,
    summed by the merge; a row's bits are every window or none; in both
    forms."""
    torch = cuda.torch
    nw, b = 4001, 77
    for seq_len in (150, 300):
        rng = np.random.default_rng(seq_len)
        codes = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8),
                          nw, 0)
        q = codes[:b].copy()
        q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # dist 0 or 3
        wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
        emb, zc = cuda.D.embed_db(torch.from_numpy(codes).to(cuda.dev),
                                  seq_len, wp)
        q_emb = cuda.D.expand_embed_query(torch.from_numpy(q).to(cuda.dev),
                                          seq_len)
        shift = cuda.K.packing_shift(seq_len, wp)
        lo, hi, cnt = held_min2(cuda, q_emb, emb, zc, seq_len, shift)
        assert ((lo & ((1 << shift) - 1)) == 0).all()
        assert ((hi & ((1 << shift) - 1)) == wp - nw).all()
        assert (cnt == nw).all()
        th = rng.integers(-1, 6, b)
        bits = held_compact(cuda, q_emb, emb, zc, th, seq_len)
        dist = (q != codes[0]).sum(axis=1)
        np.testing.assert_array_equal(bits, np.where(dist <= th, nw, 0))
