"""The port's layout choice on one device (smafa_tpu_torch.parallel.select),
mirroring smafa_tpu.parallel.select's one-device rule: past the global
31-bit key budget, or past HBM_FRACTION of the card's memory, the stream
layout; SMAFA_TPU_LAYOUT forces sharded, stream, ring or col; long windows past the global budget (smafa_tpu's top-M case)
stream too, and only windows of 2^25 - 1 bp or more raise
KeyPackingError. Also a 40M-row db whose rows are never read builds a
SlabStreamRunner, and the query batch of a stream runner is 65,536.

The port's modules are imported inside the tests: collecting must not
load torch (tests/torch_gpu_common.py says why)."""

from __future__ import annotations

import types

import numpy as np
import pytest


@pytest.fixture
def select(monkeypatch):
    import torch

    from smafa_tpu_torch.parallel import select

    for var in ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_HBM_BYTES",
                "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_SLAB_BYTES"):
        monkeypatch.delenv(var, raising=False)
    return types.SimpleNamespace(mod=select, cpu=torch.device("cpu"))


@pytest.mark.parametrize("n,layout", [(1 << 24, "sharded"),
                                      ((1 << 24) + 1, "stream")])
def test_key_budget_at_60bp(select, n, layout):
    assert select.mod.choose_layout(n, 60, select.cpu) == layout


def test_key_budget_agrees_with_smafa_tpu():
    """Where smafa_tpu's global key check flips, the port's does."""
    from smafa_tpu.ops import distance as D0
    from smafa_tpu_torch.ops import keys as K

    for L in (3, 60, 150, 1000):
        for n in (1 << 20, (1 << 22) + 3, 1 << 24, (1 << 24) + 1, 40_000_000):
            assert ((K.packing_shift(L, 2 * n) is None)
                    == (D0.packing_shift(L, 2 * n) is None))


def test_memory_sends_db_to_stream(select, monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 30))
    assert select.mod.choose_layout(10_000_000, 60, select.cpu) == "stream"
    # 1,000 rows take 320 KB resident: far under 0.75 GiB
    assert select.mod.choose_layout(1000, 60, select.cpu) == "sharded"
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 45))
    assert select.mod.choose_layout(10_000_000, 60, select.cpu) == "sharded"


def test_resident_row_bytes(select):
    # int8 twin (EP = 256 at 60 bp), uint8 codes, int32 zc
    assert select.mod.resident_row_bytes(60) == 256 + 60 + 4
    assert select.mod.resident_row_bytes(3) == 32 + 3 + 4


@pytest.mark.parametrize("env,layout", [("stream", "stream"),
                                        ("sharded", "sharded"),
                                        ("STREAM", "stream"),
                                        ("auto", "sharded"), ("", "sharded")])
def test_forced_layouts(select, monkeypatch, env, layout):
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", env)
    assert select.mod.choose_layout(1000, 60, select.cpu) == layout


@pytest.mark.parametrize("env", ["ring", "col"])
def test_forced_ring_and_col_build(select, monkeypatch, env):
    """Once refused, ring and col are ported: forced, choose_layout
    returns them, and make_runner builds their runner over one rank in
    a single-process run."""
    from smafa_tpu_torch.parallel.ring import RingRunner
    from smafa_tpu_torch.parallel.seqpar import ColumnShardedRunner

    monkeypatch.setenv("SMAFA_TPU_LAYOUT", env.upper())
    assert select.mod.choose_layout(1000, 60, select.cpu) == env
    assert select.mod.choose_layout(2**30, 150, select.cpu) == env
    codes = np.random.default_rng(0).integers(0, 4, (300, 20)).astype(np.uint8)
    r = select.mod.make_runner(codes, 20, select.cpu)
    assert type(r) is {"ring": RingRunner, "col": ColumnShardedRunner}[env]
    assert r.comm.size == 1


def test_bad_layout_raises(select, monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", "diagonal")
    with pytest.raises(ValueError, match="expected auto, sharded"):
        select.mod.choose_layout(1000, 60, select.cpu)


def test_topm_case_raises(select):
    """smafa_tpu's top-M case (no 2^24-row span packs) streams; windows
    where not even a 64-row tile packs take the wide route, whose runner
    is built without reading or allocating a row."""
    from smafa_tpu_torch.parallel.wide import WideRunner

    assert select.mod.choose_layout(2**30, 2**20, select.cpu) == "stream"
    assert select.mod.choose_layout(2**30, 2**25 - 2, select.cpu) == "stream"
    for L in (2**25 - 1, 2**25):
        assert select.mod.choose_layout(2**30, L, select.cpu) == "wide"
        codes = np.broadcast_to(np.zeros(1, np.uint8), (4, L))
        r = select.mod.make_runner(codes, L, select.cpu)
        assert type(r) is WideRunner and r.tier == "slabs"
        assert r.db_emb is None and r.wp == 64


def test_make_runner_classes(select, monkeypatch):
    from smafa_tpu_torch.parallel.runner import ScanRunner
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    codes = np.random.default_rng(0).integers(0, 4, (300, 20)).astype(np.uint8)
    assert type(select.mod.make_runner(codes, 20, select.cpu)) is ScanRunner
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", "stream")
    r = select.mod.make_runner(codes, 20, select.cpu)
    assert type(r) is SlabStreamRunner and r.n_slabs == 1


def test_forty_million_rows_build_without_reading(select):
    """As tests/test_layouts.py's test_stream_beyond_global_key_budget:
    every row of the db is one zero row, and the streaming tier (no
    capacity known on the CPU) reads none of them at construction."""
    from smafa_tpu_torch.ops import keys as K
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    n, L = 40_000_000, 60
    base = np.zeros((1, L), np.uint8)
    codes = np.lib.stride_tricks.as_strided(base, (n, L), (0, 1))
    assert select.mod.choose_layout(n, L, select.cpu) == "stream"
    r = select.mod.make_runner(codes, L, select.cpu)
    assert isinstance(r, SlabStreamRunner) and r.tier == "streaming"
    assert K.packing_shift(L, r.wp) is None      # global keys overflow
    assert r.shift is not None                   # slab-local keys fit
    assert r.n_slabs == 5 and r.slab_rows * 60 <= 1 << 29
    assert r.db_emb is None and r.h2d_bytes == 0


def test_stream_runner_takes_biggest_batch(select, monkeypatch):
    from smafa_tpu_torch.engine.query import _auto_batch
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    codes = np.zeros((100, 10), np.uint8)
    stream = SlabStreamRunner(codes, 10, select.cpu)
    assert _auto_batch(types.SimpleNamespace(runner=stream,
                                             n_windows=100)) == 65536
    resident = select.mod.make_runner(codes, 10, select.cpu)
    assert _auto_batch(types.SimpleNamespace(runner=resident,
                                             n_windows=100)) == 2048
