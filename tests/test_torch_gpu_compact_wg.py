"""compact_mask's short route (windows up to 64 bp, the warp-specialised
wgmma tile of csrc/wg_scan.cuh) against its plain PyTorch version on
the card, exact.

Each case runs through the library's C entry at one split, at the
wrapper's plan, at 7 splits and at 300 (more items than a card's
blocks), into a mask with canary rows past B that must stay untouched,
and once through the wrapper, which must launch once and take the short
route. Edges: L = 1, 31, 60 and 64; batches that are not a multiple of
the 256-row query tile; Wp = 64, Wp = 64 mod 128 (the db's trailing
64-row step alone, where rows are stored 8 bytes a step) and Wp = 0 mod
128 (16 bytes a step pair); thresholds of -1 (a row off) up to L;
padding rows (zc = -1) at distance L + 1 beside real rows at distance L
(every position a mismatch); a db of one repeated row.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu

CANARY = -7  # the words of the mask rows past B


def _launch(g, q_emb, emb, zc, thresh, seq_len, splits):
    """compact_mask through the library's C entry at ``splits`` db
    splits, into B + 3 rows of CANARY; the rows past B must stay so."""
    from smafa_tpu_torch.ops import _build

    torch = g.torch
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    mask = torch.full((b + 3, wp // 32), CANARY, dtype=torch.int32,
                      device=g.dev)
    rc = _build.load().smafa_compact_mask(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), thresh.data_ptr(),
        mask.data_ptr(), b, wp, ep, seq_len, splits,
        torch.cuda.current_stream(g.dev).cuda_stream)
    _build.check(rc, "compact_mask")
    torch.cuda.synchronize()
    assert (mask[b:] == CANARY).all(), splits
    return mask[:b]


def _held(g, q_emb, emb, zc, th, seq_len):
    """Every split count and the wrapper equal the plain version; the
    wrapper's plan is the short route. Returns the plain mask."""
    torch = g.torch
    thresh = torch.from_numpy(np.asarray(th, np.int32)).to(g.dev)
    want = g.D.compact_mask_reference(q_emb, emb, zc, thresh, seq_len)
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    route, s = g.C.kernel_plan(b, wp, ep, g.M.sm_count(g.dev))
    assert route == g.M.WG_ROUTE and 1 <= s <= wp // WP_MULTIPLE
    tiles = wp // WP_MULTIPLE
    for splits in sorted({1, s, min(7, tiles), min(300, tiles)}):
        got = _launch(g, q_emb, emb, zc, thresh, seq_len, splits)
        assert torch.equal(got, want), splits
    before = g.C.launches
    got = g.C.compact_mask(q_emb, emb, zc, thresh, seq_len)
    torch.cuda.synchronize()
    assert g.C.launches == before + 1
    assert torch.equal(got, want)
    return want


def _row_bits(mask):
    """Set bits per row of an int32 mask, as numpy."""
    words = mask.cpu().numpy().view(np.uint32)
    return np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1)


def _db(g, codes, q, seq_len):
    """(db_emb, zc, q_emb) of uint8 codes and queries on the card."""
    torch = g.torch
    wp = -(-codes.shape[0] // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(torch.from_numpy(codes).to(g.dev), seq_len, wp)
    q_emb = g.D.expand_embed_query(torch.from_numpy(q).to(g.dev), seq_len)
    return emb, zc, q_emb


@pytest.mark.parametrize("seq_len", [1, 31, 60, 64])
@pytest.mark.parametrize("nw", [5000, 70001])
def test_compact_wg_equals_plain(cuda, seq_len, nw):
    """Random rows (a tenth copies of row 3; Wp = 5056, 64 mod 128, or
    70,016, 0 mod 128) and 300 reads, thresholds from -1 to L (a tenth
    of the rows off, one row at L)."""
    rng = np.random.default_rng(seq_len)
    emb, zc, q_emb, _ = operands(cuda, seq_len, nw, 300, nw + seq_len)
    th = rng.integers(0, min(seq_len, 6) + 1, 300)
    th[rng.random(300) < 0.1] = -1
    th[7] = seq_len
    _held(cuda, q_emb, emb, zc, th, seq_len)


@pytest.mark.parametrize("b", [1, 77])
def test_compact_wg_one_step_db(cuda, b):
    """Wp = 64: one step, one split, 37 real rows; at thresh = L every
    real row's bit is set and no padding row's."""
    emb, zc, q_emb, _ = operands(cuda, 60, 37, b, b)
    assert emb.shape[0] == 64
    got = _held(cuda, q_emb, emb, zc, np.full(b, 60), 60)
    assert (_row_bits(got) == 37).all()
    _held(cuda, q_emb, emb, zc, np.arange(b) % 8 - 1, 60)


def test_compact_wg_all_mismatch_beside_padding(cuda):
    """Every real row at distance L beside padding rows at L + 1: at
    thresh = L every real row's bit is set, at L - 1 none, at -1 none."""
    seq_len, nw, b = 60, 100, 70
    codes = np.full((nw, seq_len), 2, np.uint8)
    q = np.full((b, seq_len), 1, np.uint8)
    emb, zc, q_emb = _db(cuda, codes, q, seq_len)
    th = np.where(np.arange(b) % 3 == 0, seq_len,
                  np.where(np.arange(b) % 3 == 1, seq_len - 1, -1))
    got = _held(cuda, q_emb, emb, zc, th, seq_len)
    assert (_row_bits(got) == np.where(th == seq_len, nw, 0)).all()


@pytest.mark.parametrize("nw", [70001, 70065])
def test_compact_wg_repeated_row_db(cuda, nw):
    """A db of one repeated row (Wp = 0 and 64 mod 128): a read within
    its threshold of the row sets every real row's bit in every step and
    split, the others none; every row off sets nothing."""
    seq_len, b = 60, 77
    rng = np.random.default_rng(nw)
    codes = np.repeat(rng.integers(1, 5, (1, seq_len), dtype=np.uint8), nw, 0)
    q = codes[:b].copy()
    q[:, :3] = (q[:, :3] % 4) + 1  # distance 3 from the row
    emb, zc, q_emb = _db(cuda, codes, q, seq_len)
    th = np.arange(b) % 6
    got = _held(cuda, q_emb, emb, zc, th, seq_len)
    assert (_row_bits(got) == np.where(th >= 3, nw, 0)).all()
    got = _held(cuda, q_emb, emb, zc, np.full(b, -1), seq_len)
    assert (_row_bits(got) == 0).all()
