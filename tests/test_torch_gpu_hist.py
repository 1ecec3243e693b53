"""The hist kernel (the K-mode distance histogram) against its plain
PyTorch version on the card: exact equality, one launch per call that
scans, and the route and db splits of its launch plan.

Every route at every width it serves: the split tile at L = 3, 60 and
64, the K-chunked tile with int32 bins ("kchunk") at 65, 150 and 168,
with 16-bit bins ("kchunk_stream") at 169, 300 and 1023, over a buffer
whose rows past n_valid are live, with n_valid = 3001 (a partial last
tile), the whole buffer and 0 (no launch); the split shapes B = 1, 16,
77 and 300 against 2^20 + 37 rows; n_valid = 37 (one partial tile) with
copies of the queries past it; a db of one repeated row (every row in
one bin), at 300 bp also in one split of 70,001 rows through the C
entry, so that the 16-bit bins flush past 65,280 counts; the wrapper's
refusal at HIST_MAX; and K-mode with SMAFA_TPU_KMODE_HIST=1 through the
runner on the card against the CPU.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda  # noqa: F401

pytestmark = pytest.mark.gpu

BIG = (1 << 20) + 37


def _hist(g, q_emb, emb, zc, n_valid, seq_len):
    """The kernel's histogram, held exactly to the plain version's; one
    launch when there is a row to scan."""
    before = g.HI.launches
    got = g.HI.hist(q_emb, emb, zc, n_valid, seq_len)
    want = g.D.hist_reference(q_emb, emb, zc, n_valid, seq_len)
    g.torch.cuda.synchronize()
    assert g.HI.launches == before + (n_valid > 0)
    assert g.torch.equal(got, want), n_valid
    return got


def _embed(g, buf, q, seq_len):
    wp = -(-buf.shape[0] // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(buf).to(g.dev), seq_len, wp)
    return emb, zc, g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev),
                                           seq_len)


def _plan(g, b, n_valid, seq_len):
    return g.HI.launch_plan(b, n_valid, seq_len, g.M.sm_count(g.dev))


@pytest.mark.parametrize("seq_len, route", [
    (3, "split"), (60, "split"), (64, "split"), (65, "kchunk"),
    (150, "kchunk"), (168, "kchunk"), (169, "kchunk_stream"),
    (300, "kchunk_stream"), (1023, "kchunk_stream")])
def test_hist_kernel_equals_plain(cuda, seq_len, route):
    """A 5056-row buffer whose every row is live, scanned up to n_valid
    = 3001, the whole buffer and 0; B = 300 is no multiple of any
    route's query rows a block."""
    rng = np.random.default_rng(seq_len)
    wp, b = 5056, 300
    buf = rng.integers(0, 5, (wp, seq_len), dtype=np.uint8)
    buf[rng.integers(0, 3001, 40)] = buf[5]
    q = buf[rng.integers(0, wp, b)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    q[:4] = buf[5]
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    assert _plan(cuda, b, 3001, seq_len).route == route
    for n_valid in (3001, wp, 0):
        h = _hist(cuda, q_emb, emb, zc, n_valid, seq_len)
        assert (h.sum(dim=1) == n_valid).all()


@pytest.mark.parametrize("b", [1, 16, 77, 300])
def test_hist_split_shapes(cuda, b):
    """2^20 + 37 rows at 60 bp: every batch takes S > 1 splits, whose
    bins add onto one row of the output; the last split skips the
    37-row tile's padding; B = 300 leaves most of the second query tile
    past B."""
    seq_len = 60
    rng = np.random.default_rng(b)
    buf = rng.integers(0, 4, (BIG, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, BIG, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[: max(1, b // 10)] = buf[BIG - 1]  # the last, partial tile's last row
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    plan = _plan(cuda, b, BIG, seq_len)
    assert plan.route == "split" and plan.splits > 1
    h = _hist(cuda, q_emb, emb, zc, BIG, seq_len)
    assert int(h[0, 0]) >= 1 and (h.sum(dim=1) == BIG).all()


@pytest.mark.parametrize("n_valid, seq_len", [(37, 60), (3001, 150),
                                              (37, 300)])
def test_hist_live_rows_past_n_valid(cuda, n_valid, seq_len):
    """A 70,016-row buffer scanned to n_valid: past it sit exact copies
    of the queries and rows at distance L from them, which must not
    count."""
    wp, b = 70016, 300
    rng = np.random.default_rng(n_valid + seq_len)
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    q = buf[rng.integers(0, n_valid, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    buf[n_valid:n_valid + b] = q
    buf[n_valid + b:n_valid + 2 * b] = (q + 2) % 4  # distance L
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    h = _hist(cuda, q_emb, emb, zc, n_valid, seq_len).cpu().numpy()
    dist = (q[:, None, :] != buf[None, :n_valid, :]).sum(axis=2)
    np.testing.assert_array_equal(
        h, (dist[:, :, None] == np.arange(seq_len + 1)).sum(axis=1))


@pytest.mark.parametrize("seq_len", [60, 300])
def test_hist_repeated_row_db(cuda, seq_len):
    """A db of one repeated row: each row's whole count lands in one bin
    (same-address atomics), the query's distance to the row."""
    nw, b = 70001, 300
    rng = np.random.default_rng(seq_len + 12)
    buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw,
                    axis=0)
    q = buf[:b].copy()
    q[:, :3] = (q[:, :3] + np.arange(b)[:, None] % 4) % 4  # distance 0 or 3
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    h = _hist(cuda, q_emb, emb, zc, nw, seq_len).cpu().numpy()
    dist = (q != buf[0]).sum(axis=1)
    assert (h[np.arange(b), dist] == nw).all()


def test_hist_pair_bins_flush_in_one_split(cuda):
    """300 bp, 64 reads (one query tile) against 70,001 copies of one row
    in one split through the C entry: 274 steps of 256 rows, so the
    16-bit bins flush after 255 steps (65,280 counts) and again at the
    end; every count is exact."""
    torch = cuda.torch
    seq_len, nw, b = 300, 70001, 64
    rng = np.random.default_rng(14)
    buf = np.repeat(rng.integers(0, 4, (1, seq_len), dtype=np.uint8), nw,
                    axis=0)
    q = buf[:b].copy()
    q[:, :5] = (q[:, :5] + np.arange(b)[:, None] % 4) % 4
    emb, zc, q_emb = _embed(cuda, buf, q, seq_len)
    assert _plan(cuda, b, nw, seq_len).route == "kchunk_stream"
    out = torch.empty((b, seq_len + 1), dtype=torch.int32, device=cuda.dev)
    lib = cuda.HI._build.load()
    rc = lib.smafa_hist(q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(),
                        out.data_ptr(), b, nw, q_emb.shape[1], seq_len, 1,
                        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = cuda.D.hist_reference(q_emb, emb, zc, nw, seq_len)
    assert torch.equal(out, want)
    assert int(out.max()) == nw


def test_hist_refuses_past_hist_max(cuda):
    """1024 bp: the wrapper raises on the card, as on the CPU."""
    torch = cuda.torch
    emb = torch.zeros((64, cuda.D.embed_width(1024)), dtype=torch.int8,
                      device=cuda.dev)
    zc = torch.zeros((64,), dtype=torch.int32, device=cuda.dev)
    with pytest.raises(ValueError, match="below 1024"):
        cuda.HI.hist(emb[:16].contiguous(), emb, zc, 64, 1024)


def test_kmode_with_switch_on_card(cuda, monkeypatch):
    """ScanRunner's K-mode under SMAFA_TPU_KMODE_HIST=1 on the card, at
    60 bp (split tile) and 150 bp ("kchunk"): one hist launch a batch,
    no kstats, and the CPU runner's hit lists."""
    torch = cuda.torch
    monkeypatch.setenv("SMAFA_TPU_KMODE_HIST", "1")
    for seq_len in (60, 150):
        rng = np.random.default_rng(seq_len + 15)
        codes = rng.integers(0, 4, (20000, seq_len), dtype=np.uint8)
        codes[rng.integers(0, 20000, 2000)] = codes[3]
        q = codes[rng.integers(0, 20000, 500)].copy()
        q[:5] = codes[3]
        gpu = cuda.ScanRunner(codes, seq_len, cuda.dev)
        cpu = cuda.ScanRunner(codes, seq_len, torch.device("cpu"))
        for k, maxdiv in ((99, None), (5, 3), (30000, seq_len // 4)):
            h0, s0 = cuda.HI.launches, cuda.KS.launches
            got = gpu.kmode_flat(q, k, maxdiv)
            assert (cuda.HI.launches - h0, cuda.KS.launches - s0) == (1, 0)
            for a, w in zip(got, cpu.kmode_flat(q, k, maxdiv)):
                np.testing.assert_array_equal(a, w)
