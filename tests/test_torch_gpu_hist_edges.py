"""The hist kernel's edges on the card, each call held exactly to its
plain version ``hist_reference``: windows at and around every route's
limits (1, 2, 63, 64, 65, 168, 169 and 1023 bp), batches at and around
the query tiles (B = 1, 63, 65 and 16,385) on every route, n_valid a
multiple of neither 64 nor a step, the most db splits the launch allows
(one step an item) through the C entry, and one split over a db of one
repeated row long enough that one bin of one row passes its 16-bit
flush period (per-lane bins at 60 bp, one copy a row at 150 bp).

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda  # noqa: F401

pytestmark = pytest.mark.gpu

N_VALID = 20_011  # a multiple of neither 64 nor any route's step


def _operands(g, seq_len, nw, b, seed, repeated=False):
    """db rows of codes 0-3 (every one the same row when ``repeated``)
    in a buffer of whole 64-row tiles whose rows past nw are live too,
    and reads mutated off db rows, the first ones exact copies."""
    rng = np.random.default_rng(seed)
    wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
    buf = rng.integers(0, 4, (wp, seq_len), dtype=np.uint8)
    if repeated:
        buf[:] = buf[0]
    q = buf[rng.integers(0, nw, b)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[: max(1, b // 16)] = buf[nw - 1]
    emb, zc = g.D.embed_db(g.torch.from_numpy(buf).to(g.dev), seq_len, wp)
    q_emb = g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev), seq_len)
    return emb, zc, q_emb


def _entry(g, q_emb, emb, zc, n_valid, seq_len, splits):
    """smafa_hist through the C entry at the given splits: (rc, hist)."""
    torch = g.torch
    b = q_emb.shape[0]
    out = torch.full((b, seq_len + 1), -7, dtype=torch.int32, device=g.dev)
    rc = g.HI._build.load().smafa_hist(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), out.data_ptr(), b,
        n_valid, q_emb.shape[1], seq_len, splits,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return rc, out


@pytest.mark.parametrize("seq_len", [1, 2, 63, 64, 65, 168, 169, 1023])
def test_hist_window_edges(cuda, seq_len):
    """65 reads (two query tiles of the stream route, a partial one of
    the others) against 20,011 of 20,032 live rows, through the wrapper."""
    emb, zc, q_emb = _operands(cuda, seq_len, N_VALID, 65, seq_len)
    before = cuda.HI.launches
    got = cuda.HI.hist(q_emb, emb, zc, N_VALID, seq_len)
    want = cuda.D.hist_reference(q_emb, emb, zc, N_VALID, seq_len)
    cuda.torch.cuda.synchronize()
    assert cuda.HI.launches == before + 1
    assert cuda.torch.equal(got, want)
    assert (got.sum(dim=1) == N_VALID).all()


@pytest.mark.parametrize("b", [1, 63, 65, 16385])
def test_hist_batch_edges(cuda, b):
    """Each batch at 60, 150 and 300 bp (the three routes) through the
    wrapper's plan."""
    for seq_len in (60, 150, 300):
        emb, zc, q_emb = _operands(cuda, seq_len, N_VALID, b, b + seq_len)
        plan = cuda.HI.launch_plan(b, N_VALID, seq_len,
                                   cuda.M.sm_count(cuda.dev))
        got = cuda.HI.hist(q_emb, emb, zc, N_VALID, seq_len)
        want = cuda.D.hist_reference(q_emb, emb, zc, N_VALID, seq_len)
        assert cuda.torch.equal(got, want), (seq_len, plan)


@pytest.mark.parametrize("seq_len", [60, 150, 300])
def test_hist_most_splits(cuda, seq_len):
    """splits = the route's steps over n_valid (one step an item) through
    the C entry, exact; one more is refused."""
    n_valid = 5003
    emb, zc, q_emb = _operands(cuda, seq_len, n_valid, 300, seq_len + 3)
    step = cuda.HI.route_of(seq_len).step
    steps = -(-n_valid // step)
    rc, got = _entry(cuda, q_emb, emb, zc, n_valid, seq_len, steps)
    assert rc == 0
    want = cuda.D.hist_reference(q_emb, emb, zc, n_valid, seq_len)
    assert cuda.torch.equal(got, want)
    rc, _ = _entry(cuda, q_emb, emb, zc, n_valid, seq_len, steps + 1)
    assert rc != 0


@pytest.mark.parametrize("seq_len, nw", [(60, 300_001), (150, 140_001),
                                         (300, 70_001)])
def test_hist_repeated_row_flush_in_one_split(cuda, seq_len, nw):
    """One split over copies of one row: each read's whole count lands in
    one bin, past each route's 16-bit flush period: at 60 bp a lane's
    half takes 32 a step, flushed every 2,047 steps = 262,016 rows; at
    150 bp a lane pair's 64, every 1,023 steps = 130,944 rows; at 300
    bp a row's half 256, every 255 steps."""
    emb, zc, q_emb = _operands(cuda, seq_len, nw, 256, seq_len + 9,
                               repeated=True)
    plan = cuda.HI.launch_plan(256, nw, seq_len, cuda.M.sm_count(cuda.dev))
    assert nw > plan.flush_steps * cuda.HI.route_of(seq_len).step
    rc, got = _entry(cuda, q_emb, emb, zc, nw, seq_len, 1)
    assert rc == 0
    want = cuda.D.hist_reference(q_emb, emb, zc, nw, seq_len)
    assert cuda.torch.equal(got, want)
    assert int(got.max()) == nw
