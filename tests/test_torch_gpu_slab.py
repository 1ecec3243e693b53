"""The stream layout (smafa_tpu_torch.parallel.slab) on the card: both
tiers equal the resident ScanRunner, each pass launches its kernel once
per slab, and a batch's phase A launched on the side stream ahead of the
previous batch's compaction (the query engine's order) does not disturb
either result, in the streaming tier, where every slab crosses a copy
stream.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import cuda  # noqa: F401

pytestmark = pytest.mark.gpu

SLAB_ROWS = 16384


def _case(seed=0, n=5 * SLAB_ROWS - 999, L=60, nq=3000):
    """Random windows with duplicate groups of 2, 5, 40 and 300, one of
    each across a slab boundary, and reads mutated off the db."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    for b, g in enumerate((2, 5, 40, 300), start=1):
        s = b * SLAB_ROWS - g // 2
        codes[s:s + g] = codes[s]
        codes[rng.integers(0, n, g)] = codes[rng.integers(0, n)]
    q = codes[rng.integers(0, n, nq)].copy()
    q[: 4 * 8] = codes[[b * SLAB_ROWS for b in range(1, 5)] * 8]
    mut = rng.random(q.shape) < 0.04
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    return codes, q


def _runner(cuda, monkeypatch, codes, tier):
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT",
                       "1" if tier == "resident" else "0")
    r = SlabStreamRunner(codes, codes.shape[1], cuda.dev, slab_rows=SLAB_ROWS)
    assert r.tier == tier and r.n_slabs == 5
    return r


@pytest.mark.parametrize("tier", ["resident", "streaming"])
def test_stream_runner_equals_scan_runner(cuda, monkeypatch, tier):
    codes, q = _case()
    want = cuda.ScanRunner(codes, 60, cuda.dev)
    r = _runner(cuda, monkeypatch, codes, tier)
    for maxdiv in (None, 3):
        m0 = cuda.M.launches
        got = r.best_hit(q, maxdiv)
        assert cuda.M.launches - m0 == 5
        for a, w in zip(got, want.best_hit(q, maxdiv)):
            np.testing.assert_array_equal(a, w)
    for k, maxdiv in ((99, None), (25, 6)):
        k0 = cuda.KS.launches
        got = r.kmode_flat(q[:1024], k, maxdiv)
        assert cuda.KS.launches - k0 == 3 * 5
        for a, w in zip(got, want.kmode_flat(q[:1024], k, maxdiv)):
            np.testing.assert_array_equal(a, w)
    if tier == "streaming":
        assert r.h2d_seconds() > 0 and r.h2d_bytes >= 8 * codes.nbytes


@pytest.mark.parametrize("mode", ["best", "kmode"])
def test_streaming_batches_overlap(cuda, monkeypatch, mode):
    """Batch 2's first pass is launched before batch 1 is resolved, as
    engine.query does; both equal the resident runner's."""
    codes, q = _case(seed=1)
    want = cuda.ScanRunner(codes, 60, cuda.dev)
    r = _runner(cuda, monkeypatch, codes, "streaming")
    a, b = q[:1500], q[1500:]
    if mode == "best":
        h1 = r.min_count_async(a)
        h2 = r.min_count_async(b)
        got = [r.best_hit(a, 4, handle=h1), r.best_hit(b, 4, handle=h2)]
        exp = [want.best_hit(a, 4), want.best_hit(b, 4)]
    else:
        h1 = r.kmode_stats_async(a, 40, 8)
        h2 = r.kmode_stats_async(b, 40, 8)
        got = [r.kmode_flat(a, 40, 8, stats_handle=h1),
               r.kmode_flat(b, 40, 8, stats_handle=h2)]
        exp = [want.kmode_flat(a, 40, 8), want.kmode_flat(b, 40, 8)]
    for g, e in zip(got, exp):
        for x, y in zip(g, e):
            np.testing.assert_array_equal(x, y)
