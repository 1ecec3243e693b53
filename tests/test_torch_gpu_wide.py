"""The wide route on the card: the dist_block kernel against its plain
PyTorch version (``distance.dist_block_reference``), exact, and
``WideRunner`` under a cut key budget against the same runner with the
plain version swapped in.

dist_block cases: B = 1, 16 and 77 (query tiles with rows past B); W =
64, 128 and 64 * 3 + 37 (padding rows at L + 1); L = 300 at the
wrapper's plan, at one split and at 7 splits (10 K chunks of 128 bytes
split unevenly), through the library's C entry; a db of one repeated
row and queries equal to rows; 2^16 + 5 bp (a K range of many chunks).
WideRunner: 300 bp windows, the budget cut so that no 64-row tile packs
(as tests/test_torch_wide.py), both tiers, best-hit and K-mode.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from torch_gpu_common import WP_MULTIPLE, cuda  # noqa: F401

pytestmark = pytest.mark.gpu


def _operands(g, L, w, b, seed, repeated=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (w, L), dtype=np.uint8)
    if repeated:
        codes[:] = codes[0]
    q = codes[rng.integers(0, w, b)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    q[: min(b, 2)] = codes[w - 1]
    wp = -(-w // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(codes).to(g.dev), L, wp)
    q_emb = g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev), L)
    return q_emb, emb, zc


def _launch(g, q_emb, emb, zc, L, splits):
    """dist_block through the library's C entry at ``splits`` K splits."""
    from smafa_tpu_torch.ops import _build

    torch = g.torch
    b, ep = q_emb.shape
    out = torch.full((b, emb.shape[0]), -7, dtype=torch.int32, device=g.dev)
    rc = _build.load().smafa_dist_block(
        q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(), out.data_ptr(), b,
        emb.shape[0], ep, L, splits,
        torch.cuda.current_stream(g.dev).cuda_stream)
    _build.check(rc, "dist_block")
    return out


def _held(g, q_emb, emb, zc, L, w):
    """The wrapper (one launch) and the C entry at 1, 7 and the plan's
    splits equal the plain version; padding rows read L + 1."""
    from smafa_tpu_torch.ops import dist_block as DB

    torch = g.torch
    want = g.D.dist_block_reference(q_emb, emb, zc, L)
    before = DB.launches
    got = DB.dist_block(q_emb, emb, zc, L)
    assert DB.launches == before + 1
    assert torch.equal(got, want)
    nkc = -(-q_emb.shape[1] // DB.KC)
    plan = DB.split_k(q_emb.shape[0], emb.shape[0], q_emb.shape[1],
                      g.M.sm_count(g.dev))
    for s in {1, min(7, nkc), plan}:
        assert torch.equal(_launch(g, q_emb, emb, zc, L, s), want), s
    torch.cuda.synchronize()
    assert (want[:, w:] == L + 1).all()
    return want


@pytest.mark.parametrize("b", [1, 16, 77])
@pytest.mark.parametrize("w", [64, 128, 64 * 3 + 37])
def test_dist_block_equals_plain(cuda, b, w):
    q_emb, emb, zc = _operands(cuda, 300, w, b, seed=b * 1000 + w)
    want = _held(cuda, q_emb, emb, zc, 300, w)
    assert int(want[0, w - 1]) == 0  # a copy of the last row


def test_dist_block_repeated_row_and_long_k(cuda):
    """A db of one repeated row (every column equal) at 300 bp, and 37
    queries against 100 rows of 2^16 + 5 bp (2,049 K chunks)."""
    q_emb, emb, zc = _operands(cuda, 300, 100, 16, seed=3, repeated=True)
    want = _held(cuda, q_emb, emb, zc, 300, 100)
    assert (want[:, :100] == want[:, :1]).all()
    L = (1 << 16) + 5
    q_emb, emb, zc = _operands(cuda, L, 100, 37, seed=4)
    _held(cuda, q_emb, emb, zc, L, 100)


def test_dist_block_rejects(cuda):
    """The C entry refuses splits past the K chunks; the wrapper refuses
    operands on two devices."""
    q_emb, emb, zc = _operands(cuda, 300, 64, 4, seed=5)
    with pytest.raises(RuntimeError, match="cudaError"):
        _launch(cuda, q_emb, emb, zc, 300, 11)  # 10 K chunks
    from smafa_tpu_torch.ops.dist_block import dist_block

    with pytest.raises(ValueError, match="one device"):
        dist_block(q_emb.cpu(), emb, zc, 300)


@pytest.mark.parametrize("hbm,tier", [(str(1 << 20), "slabs"),
                                      (str(1 << 40), "resident")])
def test_wide_runner_equals_plain(cuda, monkeypatch, hbm, tier):
    """WideRunner at 300 bp under a cut key budget, in slabs of 256 rows
    (a memory cut to 1 MiB) and resident, against the same runner with
    the kernel swapped for its plain version: every hit mode equal."""
    from smafa_tpu_torch.ops import keys as K
    from smafa_tpu_torch.parallel import wide
    from smafa_tpu_torch.parallel.wide import WideRunner

    real = K.packing_shift

    def cut(seq_len, wp):
        s = real(seq_len, wp)
        return s if s is not None and s + math.ceil(
            math.log2(seq_len + 2)) <= 12 else None

    monkeypatch.setattr(K, "packing_shift", cut)
    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(256 * 300))
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", hbm)
    rng = np.random.default_rng(9)
    L = 300
    pool = rng.integers(0, 5, (40, L)).astype(np.uint8)
    codes = pool[rng.integers(0, 40, 1000)]
    q = pool[rng.integers(0, 40, 90)].copy()
    q[::2, :9] = 0
    from smafa_tpu_torch.ops import dist_block as DB

    got_runner = WideRunner(codes, L, cuda.dev)
    assert got_runner.tier == tier
    before = DB.launches

    def modes(r):
        out = [r.best_hit(q), r.best_hit(q, max_divergence=3)]
        for k, md in ((99, None), (7, 4)):
            out.append(r.kmode_flat(q, k, md))
        return out

    got = modes(got_runner)
    # one block a call (four calls): a launch a slab, or one resident
    assert DB.launches - before == 4 * (got_runner.n_slabs
                                        if tier == "slabs" else 1)
    # the slab tier uploads the codes once a block, the resident one once
    assert got_runner.h2d_bytes == codes.nbytes * (4 if tier == "slabs"
                                                   else 1)
    assert got_runner.h2d_seconds() > 0
    monkeypatch.setattr(
        wide, "dist_block",
        lambda q_emb, emb, zc, seq_len: cuda.D.dist_block_reference(
            q_emb, emb, zc, seq_len))
    want = modes(WideRunner(codes, L, cuda.dev))
    for g_, w_ in zip(got, want):
        for a, b in zip(g_, w_):
            np.testing.assert_array_equal(a, b)
