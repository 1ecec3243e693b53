"""On the card: smafa_tpu's top-M case served by the stream layout, and
the cluster's centroid scan in spans, each held to its plain versions.

- A 2^20-row db of 150 bp windows with the key budget cut to 26 bits
  (in-process; the package has no knob for it): global keys (8 distance
  + 21 index bits) do not pack, so ``make_runner`` picks the stream
  layout, in 4 slabs of 2^18 rows at shift 18, the path phase 9 of
  chip_smoke.py runs at full size. Best-hit and K-mode, in both tiers,
  equal the same runner with the slab layout's kernels swapped for their
  plain versions on the card, and the resident ScanRunner at the real
  budget; min2 launches once and kstats kstats_steps(150) = 4 times per
  slab.
- ``_CentroidStore`` at 300 bp (and 60 bp) with 12 index bits: a
  20,000-row store scans its 32,768-row buffer in 5 spans of 4,096
  rows, one min_count launch each, and equals both the same scan through
  the plain version and ``distance.min_count_reference`` over the whole
  buffer at the real shift.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from torch_gpu_common import cuda  # noqa: F401

pytestmark = pytest.mark.gpu


def _cut(monkeypatch, K, fits):
    """``keys.packing_shift`` with ``fits(shift, dist_bits)`` as budget."""
    real = K.packing_shift

    def packing_shift(seq_len, wp):
        shift = real(seq_len, wp)
        dist_bits = math.ceil(math.log2(seq_len + 2))
        return shift if shift is not None and fits(shift, dist_bits) else None

    monkeypatch.setattr(K, "packing_shift", packing_shift)


def _long_case(seed=0, n=1 << 20, L=150, nq=2500):
    """Random windows with duplicate groups across the slab edges, and
    reads with 0-15 substitutions off the db."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    for b, g in enumerate((2, 5, 40), start=1):
        s = b * (1 << 18) - g // 2
        codes[s:s + g] = codes[s]
        codes[rng.integers(0, n, g)] = codes[rng.integers(0, n)]
    q = codes[rng.integers(0, n, nq)].copy()
    q[:24] = codes[[b * (1 << 18) for b in range(1, 4)] * 8]
    for i in range(nq):
        p = rng.choice(L, int(rng.integers(0, 16)), replace=False)
        q[i, p] = (q[i, p] + rng.integers(1, 4, p.size)) % 4
    return codes, q


@pytest.mark.parametrize("tier", ["resident", "streaming"])
def test_long_windows_stream_equals_plain(cuda, monkeypatch, tier):
    from smafa_tpu_torch.parallel import select, slab

    codes, q = _long_case()
    L = codes.shape[1]
    want = cuda.ScanRunner(codes, L, cuda.dev)  # real budget: global keys
    monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT",
                       "1" if tier == "resident" else "0")
    _cut(monkeypatch, cuda.K, lambda shift, dist_bits: shift + dist_bits <= 26)
    r = select.make_runner(codes, L, cuda.dev)
    assert type(r) is slab.SlabStreamRunner and r.tier == tier
    assert (r.n_slabs, r.slab_rows, r.shift) == (4, 1 << 18, 18)
    plain = select.make_runner(codes, L, cuda.dev)
    for mode, arg in (("best", None), ("best", 12), ("kmode", (99, None)),
                      ("kmode", (30, 20))):
        def call(runner):
            return (runner.best_hit(q, arg) if mode == "best"
                    else runner.kmode_flat(q[:1024], *arg))

        m0, k0 = cuda.M.launches, cuda.KS.launches
        got = call(r)
        if mode == "best":
            assert cuda.M.launches - m0 == 4
        else:
            assert cuda.KS.launches - k0 == 4 * cuda.K.kstats_steps(L)
        with monkeypatch.context() as m:
            m.setattr(slab, "min2", cuda.D.min2_reference)
            m.setattr(slab, "kstats", cuda.D.stats_reference)
            m.setattr(slab, "compact_mask", cuda.D.compact_mask_reference)
            counts = (cuda.M.launches, cuda.KS.launches, cuda.C.launches)
            ref = call(plain)
            assert (cuda.M.launches, cuda.KS.launches,
                    cuda.C.launches) == counts  # no kernel ran
        for g, p, e in zip(got, ref, call(want)):
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("seq_len", [300, 60])
def test_span_scan_equals_plain(cuda, monkeypatch, seq_len):
    from smafa_tpu_torch.engine import cluster

    rng = np.random.default_rng(seq_len)
    n, L = 20000, seq_len
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    codes[[4096 + 5, 8192 + 9, 19999]] = codes[7]  # ties in 4 spans
    q = codes[rng.integers(0, n, 3000)].copy()
    mut = rng.random(q.shape) < 0.1
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    q[:4] = codes[[7, 19999, 8192 + 9, 12345]]
    real_shift = cuda.K.packing_shift(L, 32768)
    _cut(monkeypatch, cuda.K, lambda shift, _dist_bits: shift <= 12)
    store = cluster._CentroidStore.from_codes(codes, cuda.dev)
    assert (store.cap, store.span, store.shift) == (32768, 4096, 12)
    l0 = cuda.MC.launches
    dist, idx = store.scan_fetch(store.scan_async(q))
    assert cuda.MC.launches - l0 == 5
    assert list(idx[:4]) == [7, 7, 7, 12345] and list(dist[:4]) == [0] * 4
    with monkeypatch.context() as m:
        m.setattr(cluster, "min_count", cuda.D.min_count_reference)
        plain = store.scan_fetch(store.scan_async(q))
    assert cuda.MC.launches - l0 == 5
    q_emb = cuda.D.expand_embed_query(cuda.torch.from_numpy(q).to(cuda.dev), L)
    (key,) = cuda.D.min_count_reference(q_emb, store.db_emb, store.zc, n, L,
                                        real_shift, with_count=False)
    whole = [t.cpu().numpy() for t in cuda.D.unpack_min_key(key, real_shift)]
    for g, p, w in zip((dist, idx), plain, whole):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)
