"""compact_mask's long route (windows past 64 bp, csrc/wg_long.cuh)
against its plain PyTorch version on the card, exact.

Form (a), "wg_kchunk", the query rows resident, serves EP <= 640 (L <=
160); form (b), "wg_kchunk_stream", query and db chunks streamed, serves
longer windows. Each case runs
at one split, at the wrapper's plan and at 7 splits (a count that
divides no tile run evenly), through the library's C entry into a mask
filled with a sentinel (so a word no block writes shows), and once
through the wrapper, which must launch once and take the plan's route.
Cases: L = 65 (three chunks of 128 bytes, the last of 32), 127, 150 (five,
the last of 96), 168 and 169 (past form (a)'s 160) and 300 (ten, the last
of 64) with thresholds in [-1, L]; thresh = -1 everywhere (no bit) and thresh =
L everywhere (every real window, no padding row); batches of 1, 33 and
257 rows (below 256 and not a multiple of it); a db of one repeated row;
29,903 bp on a small db.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda  # noqa: F401

pytestmark = pytest.mark.gpu

SENTINEL = 0x5A5A5A5A


def _launch(g, q_emb, emb, zc, thresh, seq_len, splits):
    """compact_mask through the library's C entry at ``splits`` db
    splits, into a mask filled with SENTINEL."""
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


def _held(g, q_emb, emb, zc, th, seq_len):
    """The C entry at 1 and 7 splits and at the plan's, and the wrapper,
    equal the plain version; the plan is the long route of this width.
    Returns the set bits per row, as numpy."""
    torch = g.torch
    thresh = torch.from_numpy(np.asarray(th, np.int32)).to(g.dev)
    want = g.D.compact_mask_reference(q_emb, emb, zc, thresh, seq_len)
    b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
    route, s = g.C.kernel_plan(b, wp, ep, g.M.sm_count(g.dev))
    tiles = wp // WP_MULTIPLE
    assert route == ("wg_kchunk" if ep <= 640 else "wg_kchunk_stream")
    assert 1 <= s <= tiles
    for n in sorted({min(x, tiles) for x in (1, 7, s)}):
        got = _launch(g, q_emb, emb, zc, thresh, seq_len, n)
        torch.cuda.synchronize()
        assert torch.equal(got, want), n
    before = g.C.launches
    got = g.C.compact_mask(q_emb, emb, zc, thresh, seq_len)
    torch.cuda.synchronize()
    assert g.C.launches == before + 1
    assert torch.equal(got, want)
    words = want.cpu().numpy().view(np.uint32)
    return np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1)


def _operands(g, buf, q, seq_len):
    """(db_emb, zc, q_emb) on the card, the buffer padded to the 64-row
    tile with padding rows (zc = -1, zero embedding)."""
    wp = -(-buf.shape[0] // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(buf).to(g.dev), seq_len, wp)
    return emb, zc, g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev),
                                           seq_len)


def _case(seq_len, nw, b, seed, subs=0.05):
    """nw random rows over codes 0-3 (a tenth of them copies of row 5)
    and b reads off them with ~subs substitutions, the first 4 copies of
    row 5."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, (nw, seq_len), dtype=np.uint8)
    buf[rng.integers(0, nw, nw // 10)] = buf[5]
    q = buf[rng.integers(0, nw, b)].copy()
    mut = rng.random(q.shape) < subs
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[:4] = buf[5]
    return rng, buf, q


@pytest.mark.parametrize("seq_len", [65, 127, 150, 168, 169, 300])
def test_compact_kchunk_equals_plain(cuda, seq_len):
    """5,000 rows (padded to 5,056) and 300 reads, thresholds in [-1, L]
    with the first 8 rows at L (every real window set) and the next 8 at
    -1 (none); no padding row sets a bit."""
    nw, b = 5000, 300
    rng, buf, q = _case(seq_len, nw, b, seq_len)
    emb, zc, q_emb = _operands(cuda, buf, q, seq_len)
    th = rng.integers(-1, seq_len + 1, b)
    th[:8], th[8:16] = seq_len, -1
    bits = _held(cuda, q_emb, emb, zc, th, seq_len)
    assert (bits[:8] == nw).all() and (bits[8:16] == 0).all()


@pytest.mark.parametrize("kind", ["off", "all"])
def test_compact_kchunk_extreme_thresholds(cuda, kind):
    """thresh = -1 everywhere sets no bit; thresh = L sets every real
    window and no padding row; in both forms (150 and 300 bp)."""
    nw, b = 9001, 77
    for seq_len in (150, 300):
        _, buf, q = _case(seq_len, nw, b, seq_len + 1, subs=0.5)
        emb, zc, q_emb = _operands(cuda, buf, q, seq_len)
        bits = _held(cuda, q_emb, emb, zc,
                     np.full(b, -1 if kind == "off" else seq_len), seq_len)
        assert (bits == (0 if kind == "off" else nw)).all()


@pytest.mark.parametrize("b", [1, 33, 257])
def test_compact_kchunk_small_batches(cuda, b):
    """Batches below the 256-row query block or one row past it: rows
    past B (zero-filled by the boxes) set nothing; the plan splits the
    6,000-row db so its items fill the card; in both forms."""
    for seq_len in (150, 300):
        rng, buf, q = _case(seq_len, 6000, b, b + seq_len)
        emb, zc, q_emb = _operands(cuda, buf, q, seq_len)
        th = rng.integers(-1, seq_len // 3, b)
        th[0] = seq_len // 2
        bits = _held(cuda, q_emb, emb, zc, th, seq_len)
        assert bits[0] > 0


def test_compact_kchunk_repeated_row_db(cuda):
    """A db of one repeated row: a row's bits are every window or none,
    in both forms."""
    nw, b = 7001, 77
    for seq_len in (150, 300):
        rng = np.random.default_rng(seq_len + 2)
        buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw,
                        axis=0)
        q = buf[:b].copy()
        q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # dist 0 or 3
        emb, zc, q_emb = _operands(cuda, buf, q, seq_len)
        th = rng.integers(-1, 6, b)
        bits = _held(cuda, q_emb, emb, zc, th, seq_len)
        dist = (q != buf[0]).sum(axis=1)
        np.testing.assert_array_equal(bits, np.where(dist <= th, nw, 0))


def test_compact_kchunk_29903bp(cuda):
    """A SARS-CoV-2 genome's width, form (b), 935 chunks a row: 637 rows
    (padded to 640) and 40 reads with ~1% substitutions, thresholds up to
    400 and L."""
    seq_len, nw, b = 29903, 637, 40
    rng, buf, q = _case(seq_len, nw, b, 3, subs=0.01)
    emb, zc, q_emb = _operands(cuda, buf, q, seq_len)
    assert q_emb.shape[1] == 119616
    th = rng.integers(0, 400, b)
    th[-3:] = seq_len
    bits = _held(cuda, q_emb, emb, zc, th, seq_len)
    copies = int((buf == buf[5]).all(axis=1).sum())  # at distance 0
    assert (bits[-3:] == nw).all() and (bits[:4] >= copies).all()
