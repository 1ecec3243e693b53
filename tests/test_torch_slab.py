"""The port's stream layout (smafa_tpu_torch.parallel.slab) on the CPU,
mirroring tests/test_layouts.py's stream tests: over several slabs, with
duplicate groups that straddle slab boundaries, its best-hit and K-mode
results equal smafa_tpu's SlabStreamRunner and its ScanRunner on a 1x1
mesh exactly (every value an integer: tolerance 0); the resident tier
equals the streaming tier; a last slab of one real row, a monster tie
row and the slab plan; the slab merge of phase A against one whole-db
min2 pass.

The port's modules are imported inside the tests: collecting must not
load torch (tests/torch_gpu_common.py says why)."""

from __future__ import annotations

import numpy as np
import pytest


def _cpu():
    import torch

    return torch.device("cpu")


def _db(seed: int, n: int, L: int, slab_rows: int):
    """Random codes (N included) with duplicate groups of 2, 5 and 40,
    one group of each size placed across a slab boundary, and reads:
    copies of the grouped rows, mutated copies, random rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (n, L)).astype(np.uint8)
    for g, b in zip((2, 5, 40), range(1, 4)):
        start = b * slab_rows - g // 2  # straddles slab boundary b
        codes[start:start + g] = codes[start]
        for _ in range(3):  # and scattered copies elsewhere
            codes[rng.integers(0, n, g)] = rng.integers(0, 5, L)
    picks = codes[rng.integers(0, n, 24)]
    mutated = picks.copy()
    mutated[:, : max(1, L // 6)] = rng.integers(0, 5, (24, max(1, L // 6)))
    q = np.concatenate([codes[[slab_rows, 2 * slab_rows, 3 * slab_rows]],
                        picks, mutated,
                        rng.integers(0, 5, (9, L)).astype(np.uint8)])
    return codes, q


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("L,slab_rows", [(10, 64), (10, 128), (60, 64),
                                         (60, 128)])
def test_stream_matches_smafa_tpu(L, slab_rows):
    from smafa_tpu.parallel import sharded, slab as slab0
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    codes, q = _db(L + slab_rows, 7 * slab_rows - 11, L, slab_rows)
    ref = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1))
    st0 = slab0.SlabStreamRunner(codes, L, slab_rows=slab_rows // 2,
                                 chunk=32)
    st = SlabStreamRunner(codes, L, _cpu(), slab_rows=slab_rows)
    assert st.n_slabs >= 6 and st.tier == "streaming"
    for args in ((), (3,)):
        want = ref.best_hit(q, *args)
        _same(st0.best_hit(q, *args), want)
        _same(st.best_hit(q, *args), want)
    assert int(np.asarray(want[1]).sum()) > q.shape[0]  # ties ran
    for k, maxdiv in ((25, 4), (1000, None)):  # K > n_windows: the row max
        want = ref.kmode_flat(q, k, maxdiv)
        _same(st0.kmode_flat(q, k, maxdiv), want)
        _same(st.kmode_flat(q, k, maxdiv), want)


@pytest.mark.parametrize("L", [10, 60])
def test_resident_tier_equals_streaming_tier(monkeypatch, L):
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    codes, q = _db(3, 500, L, 64)
    monkeypatch.delenv("SMAFA_TPU_SLAB_RESIDENT", raising=False)
    streaming = SlabStreamRunner(codes, L, _cpu(), slab_rows=64)
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 40))
    resident = SlabStreamRunner(codes, L, _cpu(), slab_rows=64)
    assert (streaming.tier, resident.tier) == ("streaming", "resident")
    assert streaming.db_emb is None and resident.db_emb.shape[0] == 512
    _same(resident.best_hit(q), streaming.best_hit(q))
    _same(resident.best_hit(q, 2), streaming.best_hit(q, 2))
    _same(resident.kmode_flat(q, 30, None), streaming.kmode_flat(q, 30, None))
    _same(resident.kmode_flat(q, 9, 5), streaming.kmode_flat(q, 9, 5))


@pytest.mark.parametrize("env,hbm,tier", [
    ("1", None, "resident"), ("0", 1 << 40, "streaming"),
    ("", 1 << 40, "resident"),
    ("", 256, "streaming"), ("", None, "streaming")])
def test_tier_choice(monkeypatch, env, hbm, tier):
    """SMAFA_TPU_SLAB_RESIDENT decides when set; else the cache must fit
    CODES_RESIDENT_FRACTION of the capacity, which is unknown on the
    CPU unless SMAFA_TPU_HBM_BYTES says."""
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT", env)
    if hbm is None:
        monkeypatch.delenv("SMAFA_TPU_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(hbm))
    codes, _ = _db(4, 300, 10, 64)
    assert SlabStreamRunner(codes, 10, _cpu(), slab_rows=64).tier == tier


def test_last_slab_of_one_real_row():
    """The last slab holds one real row and 63 poisoned ones; its window
    is the unique best hit of one read and ties with the first row for
    another."""
    from smafa_tpu.parallel import sharded
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    rng = np.random.default_rng(5)
    L = 12
    codes = rng.integers(0, 4, (4 * 64 + 1, L)).astype(np.uint8)
    codes[0] = codes[-1]
    last = codes[-1].copy()
    q = np.stack([last, (last + 1) % 4, codes[7]])
    st = SlabStreamRunner(codes, L, _cpu(), slab_rows=64)
    assert st.n_slabs == 5 and st.n_windows - 4 * 64 == 1
    want = sharded.ScanRunner(codes, L, mesh=sharded.build_mesh(1, 1))
    got = st.best_hit(q)
    _same(got, want.best_hit(q))
    assert got[3][:2].tolist() == [0, codes.shape[0] - 1]
    _same(st.kmode_flat(q, 300, None), want.kmode_flat(q, 300, None))


def test_monster_tie_row_takes_host_path(monkeypatch):
    """With COMPACT_MAX at 50, a read tied with a 60-row duplicate group
    spread over 4 slabs is enumerated on the host, best-hit and K-mode."""
    from smafa_tpu_torch.parallel import hitops
    from smafa_tpu_torch.parallel.runner import ScanRunner
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    rng = np.random.default_rng(6)
    L = 16
    codes = rng.integers(0, 4, (300, L)).astype(np.uint8)
    codes[rng.choice(300, 60, replace=False)] = codes[5]
    q = np.stack([codes[5], codes[9], codes[5] ^ 1])
    want_b = ScanRunner(codes, L, _cpu()).best_hit(q)
    want_k = ScanRunner(codes, L, _cpu()).kmode_flat(q, 70, None)
    calls = []
    real = hitops.HitModesMixin._host_enumerate_row
    monkeypatch.setattr(hitops, "COMPACT_MAX", 50)
    monkeypatch.setattr(SlabStreamRunner, "_host_enumerate_row",
                        lambda self, *a: calls.append(1) or real(self, *a))
    st = SlabStreamRunner(codes, L, _cpu(), slab_rows=64)
    _same(st.best_hit(q), want_b)
    assert calls
    del calls[:]
    _same(st.kmode_flat(q, 70, None), want_k)
    assert calls


@pytest.mark.parametrize("n,budget,plan", [
    (1000, 64 * 10 * 4, (256, 4)),   # 4 slabs of 256 rows, last 232
    (64 * 5 + 1, 64 * 10 * 4, (192, 2)),  # balanced: not 256 + 65
    (0, 1 << 29, (64, 1)),
])
def test_slab_plan(monkeypatch, n, budget, plan):
    from smafa_tpu_torch.parallel import slab

    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(budget))
    slab_rows, n_slabs = slab.slab_plan(n, 10)
    assert (slab_rows, n_slabs) == plan
    assert slab_rows % 64 == 0 and (n_slabs - 1) * slab_rows < max(n, 1)


def test_slab_plan_matches_smafa_tpu(monkeypatch):
    """At chunk = 64, smafa_tpu's plan for the same byte budget."""
    from smafa_tpu.parallel import slab as slab0
    from smafa_tpu_torch.parallel import slab

    for n, budget in ((1000, 2560), (5000, 10_000), (70_001, 1 << 20)):
        monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(budget))
        codes = np.zeros((n, 10), np.uint8)
        st0 = slab0.SlabStreamRunner(codes, 10, chunk=64)
        assert slab.slab_plan(n, 10) == (st0.slab_rows, st0.n_slabs)


def test_slab_rows_and_keys_checked(monkeypatch):
    """Slab rows are whole tiles; at 2^25 bp no slab packs, the stream
    layout names the wide route, and a forced stream layout builds it."""
    from smafa_tpu_torch.parallel.runner import KeyPackingError
    from smafa_tpu_torch.parallel.select import make_runner
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner
    from smafa_tpu_torch.parallel.wide import WideRunner

    codes = np.zeros((100, 10), np.uint8)
    with pytest.raises(ValueError, match="multiple of 64"):
        SlabStreamRunner(codes, 10, _cpu(), slab_rows=100)
    wide = np.broadcast_to(np.zeros(1, np.uint8), (100, 2**25))
    with pytest.raises(KeyPackingError, match="parallel.wide.WideRunner"):
        SlabStreamRunner(wide, 2**25, _cpu(), slab_rows=64)
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", "stream")
    r = make_runner(wide, 2**25, _cpu())
    assert type(r) is WideRunner and (r.wp, r.db_emb) == (128, None)


def test_pair_merge_equals_whole_db_min2():
    """Phase A merged over 7 slabs equals one min2 pass over the whole db,
    decoded: dist, lowest and highest tied index, tie count; rows whose
    min lies in one slab, across slabs, and in the last slab's real rows."""
    import torch

    from smafa_tpu_torch.ops import distance as D, keys as K

    L, slab_rows = 24, 64
    codes, q = _db(9, 7 * slab_rows - 5, L, slab_rows)
    dev = _cpu()
    n = codes.shape[0]
    emb, zc = D.embed_db(torch.from_numpy(codes), L, 7 * slab_rows)
    q_emb = D.expand_embed_query(torch.from_numpy(q), L)
    shift_g = K.packing_shift(L, 7 * slab_rows)
    lo, hi, cnt = D.min2_reference(q_emb, emb, zc, L, shift_g)
    dist, idx_lo = K.unpack_key(lo.numpy(), shift_g)
    idx_hi = 7 * slab_rows - 1 - (hi.numpy() & ((1 << shift_g) - 1))
    shift = K.packing_shift(L, slab_rows)
    carry = D.min2_pair_init(q.shape[0], dev)
    for off in range(0, 7 * slab_rows, slab_rows):
        s = slice(off, off + slab_rows)
        lo_s, hi_s, cnt_s = D.min2_reference(q_emb, emb[s], zc[s], L, shift)
        carry = D.min2_pair_merge(carry, lo_s, hi_s, cnt_s, off, slab_rows,
                                  shift, L)
    pair, count = D.min2_pair_finish(carry)
    np.testing.assert_array_equal(pair[0].numpy(), dist)
    np.testing.assert_array_equal(pair[1].numpy(), idx_lo)
    np.testing.assert_array_equal(pair[2].numpy(), idx_hi)
    np.testing.assert_array_equal(count.numpy(), cnt.numpy())
    assert (pair[2].numpy() < n).all() and (pair[1] != pair[2]).any()


def test_pair_form_empty_rows_and_unpack():
    """An all-empty carry finishes to the sentinels on both sides, which
    _min2_unpack reads as not found; the merge skips a slab of padding
    rows only (min past L)."""
    import torch

    from smafa_tpu_torch.ops import distance as D
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    dev = _cpu()
    carry = D.min2_pair_init(3, dev)
    pad = torch.full((3,), (10 + 1) << 6 | 5, dtype=torch.int32)
    carry = D.min2_pair_merge(carry, pad, pad, torch.full((3,), 64,
                              dtype=torch.int32), 128, 64, 6, 10)
    pair, cnt = D.min2_pair_finish(carry)
    assert pair.tolist() == [[2**30] * 3, [2**31 - 1] * 3, [2**31 - 1] * 3]
    assert cnt.tolist() == [0, 0, 0]
    st = SlabStreamRunner(np.zeros((64, 10), np.uint8), 10, dev)
    d, il, ih, found = st._min2_unpack(pair.numpy())
    assert not found.any() and (il == ih).all()
