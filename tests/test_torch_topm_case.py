"""smafa_tpu's top-M case in the port: long windows (127 bp or more)
whose keys do not pack into 31 bits even over smafa_tpu's 2^24-row span.
smafa_tpu serves them with its exact top-M sort-merge
(``ScanRunner.topm`` through ``engine.query._scan_batch``); the port
streams them in slabs no wider than ``keys.packing_span``.

Both key budgets are cut to 16 bits in-process (neither package has a
knob for it), so a ~3,000-row heavy-tie fuzz db at 127 and 150 bp takes
that case: smafa_tpu picks ``sharded`` and its ``topm`` serves the query
(a spy shows it ran), and the port picks ``stream`` in slabs of 256 rows
(8 distance bits + 8 index bits). The port's stdout through its CLI must
equal, byte for byte, both smafa_tpu's top-M run and smafa_tpu's
unpatched run, in best-hit and K-mode; a forced SMAFA_TPU_LAYOUT=sharded
and a slab byte budget wider than the span are served the same way.
Windows of 2^25 - 1 bp or more take the wide route
(test_torch_wide.py)."""

from __future__ import annotations

import math

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from test_torch_query import _fuzz_files

LAYOUT_VARS = ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
               "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES")
BUDGET_BITS = 16
N_DB = 3000
SPAN = 256  # 16 bits less 8 distance bits at 127-254 bp


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    for var in LAYOUT_VARS:
        monkeypatch.delenv(var, raising=False)


def cut_budget(real, fits=lambda shift, dist_bits:
               shift + dist_bits <= BUDGET_BITS):
    """``packing_shift`` that packs only where ``fits(index bits, distance
    bits)``; by default a key budget of BUDGET_BITS bits."""
    def packing_shift(seq_len, wp):
        shift = real(seq_len, wp)
        dist_bits = math.ceil(math.log2(seq_len + 2))
        return shift if shift is not None and fits(shift, dist_bits) else None
    return packing_shift


def run(capsys, main, *argv):
    code = main(list(argv))
    cap = capsys.readouterr()
    assert code == 0, cap.err
    return cap.out


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """(db path, reads path) per window length, built by smafa_tpu."""
    import contextlib
    import io

    out = {}
    for L in (127, 150):
        tmp = tmp_path_factory.mktemp(f"topm{L}")
        db_fa, q_fa = _fuzz_files(tmp, seed=L, n=N_DB, nq=200, L=L)
        db = str(tmp / "db")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main0(["makedb", "-i", db_fa, "-d", db]) == 0
        out[L] = (db, q_fa)
    return out


def topm_reference(capsys, monkeypatch, db, q, *extra):
    """smafa_tpu's stdout with its key budget cut: ScanRunner's top-M
    path serves it (asserted by a spy)."""
    from smafa_tpu.ops import distance as D0
    from smafa_tpu.parallel import select as select0, sharded

    served = []
    real_topm = sharded.ScanRunner.topm
    with monkeypatch.context() as m:
        m.setattr(D0, "packing_shift", cut_budget(D0.packing_shift))
        m.setattr(sharded.ScanRunner, "topm",
                  lambda self, *a, **kw: served.append(1)
                  or real_topm(self, *a, **kw))
        assert select0.choose_layout(N_DB, 150) == "sharded"
        out = run(capsys, main0, "query", "-d", db, "-q", q, *extra)
    assert served, "smafa_tpu's top-M path did not serve the query"
    return out


def port(capsys, monkeypatch, db, q, *extra, env=None):
    """The port's stdout with its key budget cut, and the runner built."""
    from smafa_tpu_torch.ops import keys as K
    from smafa_tpu_torch.parallel import select

    made, make = [], select.make_runner
    with monkeypatch.context() as m:
        m.setattr(K, "packing_shift", cut_budget(K.packing_shift))
        m.setattr(select, "make_runner",
                  lambda *a: made.append(make(*a)) or made[-1])
        for var, val in (env or {}).items():
            m.setenv(var, val)
        out = run(capsys, main1, "query", "-d", db, "-q", q, *extra)
    return out, made[0]


def check(capsys, monkeypatch, dbs, L, extra, env=None):
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    db, q = dbs[L]
    got, runner = port(capsys, monkeypatch, db, q, *extra, env=env)
    assert type(runner) is SlabStreamRunner
    assert (runner.slab_rows, runner.n_slabs) == (SPAN, -(-N_DB // SPAN))
    assert runner.shift == 8
    assert got == topm_reference(capsys, monkeypatch, db, q, *extra)
    assert got == run(capsys, main0, "query", "-d", db, "-q", q, *extra)
    return got


@pytest.mark.parametrize("L", [127, 150])
@pytest.mark.parametrize("extra", [
    [], ["--max-divergence", "3"],
    ["--max-num-hits", "30", "--limit-per-sequence", "2"],
    ["--max-num-hits", "99", "--max-divergence", "5"]],
    ids=["best", "best_div3", "kmode_limit", "kmode_div5"])
def test_topm_case_equals_smafa_tpu(capsys, monkeypatch, dbs, L, extra):
    out = check(capsys, monkeypatch, dbs, L, [*extra, "--batch-size", "64"])
    assert out.count("\n") >= 50


@pytest.mark.parametrize("tier", ["1", "0"])
def test_forced_sharded_streams(capsys, monkeypatch, dbs, tier):
    """SMAFA_TPU_LAYOUT=sharded past the global budget: ScanRunner cannot
    pack it, so make_runner builds the stream layout, in either tier."""
    check(capsys, monkeypatch, dbs, 150, ["--max-num-hits", "7"],
          env={"SMAFA_TPU_LAYOUT": "sharded",
               "SMAFA_TPU_SLAB_RESIDENT": tier})


def test_slab_bytes_capped_at_span(capsys, monkeypatch, dbs):
    """A slab byte budget of 4,000 rows is cut to the 256-row span."""
    check(capsys, monkeypatch, dbs, 127, [],
          env={"SMAFA_TPU_SLAB_BYTES": str(4000 * 127)})


def test_slab_plan_at_150bp():
    """At the real budget: 5,242,880 windows of 150 bp (past 2^22, where
    smafa_tpu takes the top-M case) stream in 2 slabs of 2,621,440 rows
    at shift 22 (22 + 8 = 30 bits); a 2^33-byte slab budget is capped at
    the 2^23-row span; a compaction dispatch takes 2,048 rows."""
    from smafa_tpu_torch.ops import keys as K
    from smafa_tpu_torch.parallel import hitops, slab

    n = (1 << 22) + (1 << 20)
    assert K.packing_shift(150, 2 * n) is None
    assert slab.slab_plan(n, 150) == (2_621_440, 2)
    assert K.packing_shift(150, 2_621_440) == 22
    assert hitops.mask_row_cap(2_621_440) == 2048
    with pytest.MonkeyPatch.context() as m:
        m.setenv("SMAFA_TPU_SLAB_BYTES", str(1 << 33))
        assert slab.slab_plan(1 << 26, 150) == (1 << 23, 8)


@pytest.mark.parametrize("L,span", [(126, 1 << 24), (127, 1 << 23),
                                    (254, 1 << 23), (255, 1 << 22),
                                    ((1 << 25) - 2, 64), ((1 << 25) - 1, None)])
def test_packing_span(L, span):
    """The widest 64-row multiple whose local keys pack: 2^(31 - dist
    bits), None from 2^25 - 1 bp on; it agrees with packing_shift."""
    from smafa_tpu_torch.ops import keys as K

    assert K.packing_span(L) == span
    if span is not None:
        assert K.packing_shift(L, span) is not None
        assert K.packing_shift(L, 2 * span) is None


def test_refusal_past_one_tile():
    """Windows of 2^25 - 1 bp: no 64-row tile packs, so the layout choice
    and a forced sharded or stream layout build the wide route, and the
    cluster's store plans its wide scan, before any row is read or any
    buffer allocated."""
    import torch

    from smafa_tpu_torch.engine.cluster import _CentroidStore
    from smafa_tpu_torch.parallel import select
    from smafa_tpu_torch.parallel.wide import WideRunner

    L = (1 << 25) - 1
    codes = np.broadcast_to(np.zeros(1, np.uint8), (4, L))
    cpu = torch.device("cpu")
    for layout in ("auto", "sharded", "stream"):
        with pytest.MonkeyPatch.context() as m:
            m.setenv("SMAFA_TPU_LAYOUT", layout)
            r = select.make_runner(codes, L, cpu)
            assert type(r) is WideRunner and r.db_emb is None
    store = _CentroidStore(L, cpu)
    assert (store.shift, store.span, store.db_emb) == (None, None, None)
