"""K-mode under ``SMAFA_TPU_KMODE_HIST=1`` on the CPU: the port takes the
histogram exactly where smafa_tpu does (windows below HIST_MAX), and
prints what smafa_tpu prints under the same switch. ``ScanRunner``'s
``kmode_flat`` with the switch on and off equals smafa_tpu's with it on
(tests/test_layouts.py:500's pairs); at 1024 bp the switch leaves the
kstats search in place (a spy on ``_hist``); the CLI's bytes equal
smafa_tpu's on the golden files, on the seeded heavy-tie fuzz db, and
under the stream layout in both tiers."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from test_torch_kmode import jax_runner_per_db  # noqa: F401 (fixture)
from test_torch_query import GOLDEN_FILES, _fuzz_files, run

D = "tests/data"
SWITCH = "SMAFA_TPU_KMODE_HIST"
LAYOUT_VARS = ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
               "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv(SWITCH, "1")
    for var in LAYOUT_VARS:
        monkeypatch.delenv(var, raising=False)


class HistSpy:
    """Counts the calls of ``cls._hist`` and ``cls._kstats``."""

    def __init__(self, monkeypatch, cls):
        self.calls = {"_hist": 0, "_kstats": 0}
        for name in self.calls:
            real = getattr(cls, name)

            def spy(self_, *a, _real=real, _name=name):
                self.calls[_name] += 1
                return _real(self_, *a)

            monkeypatch.setattr(cls, name, spy)


def _layouts_case():
    """tests/test_layouts.py:500's db and reads (24 bp, a copied row)."""
    rng = np.random.default_rng(71)
    L, n = 24, 500
    db = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    db[50] = db[10]
    q = rng.integers(0, 4, size=(19, L)).astype(np.uint8)
    q[:2] = db[10:12]
    return db, q, L


@pytest.mark.parametrize("k, maxdiv", [(5, None), (99, 4), (1000, None),
                                       (2, 0)])
def test_kmode_flat_switch_equals_smafa_tpu(monkeypatch, k, maxdiv):
    """One histogram pass with the switch on, the kstats search with it
    off: both equal smafa_tpu's runner with the switch on."""
    import torch

    from smafa_tpu.parallel import sharded
    from smafa_tpu_torch.parallel.runner import ScanRunner

    db, q, L = _layouts_case()
    want = sharded.ScanRunner(db, L, mesh=sharded.build_mesh(1, 1),
                              chunk=64).kmode_flat(q, k, maxdiv)
    spy = HistSpy(monkeypatch, ScanRunner)
    r = ScanRunner(db, L, torch.device("cpu"))
    for on, calls in (("1", {"_hist": 1, "_kstats": 0}),
                      ("0", {"_hist": 1, "_kstats": 3})):
        monkeypatch.setenv(SWITCH, on)
        got = r.kmode_flat(q, k, maxdiv)
        assert spy.calls == calls
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("L, takes_hist", [(1023, True), (1024, False)])
def test_switch_stops_at_hist_max(monkeypatch, L, takes_hist):
    """At HIST_MAX = 1024 bp the switch on leaves the kstats search in
    place (as smafa_tpu's ``_kmode_hist_enabled``); one below it takes
    the histogram. Both print the switch-off hit lists."""
    import torch

    from smafa_tpu_torch.ops import keys
    from smafa_tpu_torch.parallel.runner import ScanRunner

    rng = np.random.default_rng(L)
    db = rng.integers(0, 4, size=(100, L)).astype(np.uint8)
    db[7] = db[3]
    q = db[[3, 50, 99]].copy()
    q[1, :40] = 0
    r = ScanRunner(db, L, torch.device("cpu"))
    monkeypatch.setenv(SWITCH, "0")
    want = r.kmode_flat(q, 5, None)
    spy = HistSpy(monkeypatch, ScanRunner)
    monkeypatch.setenv(SWITCH, "1")
    got = r.kmode_flat(q, 5, None)
    assert r._kmode_hist_enabled() is takes_hist
    assert spy.calls == ({"_hist": 1, "_kstats": 0} if takes_hist else
                         {"_hist": 0, "_kstats": keys.kstats_steps(L)})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fname", GOLDEN_FILES)
def test_golden_kmode_with_switch(capsys, tmp_path, jax_runner_per_db,
                                  fname):
    """Each package queries the db the other wrote, both under the
    switch; K, the divergence and the limit per sequence crossed."""
    dbs = {}
    for i, main in enumerate((main0, main1)):
        db = str(tmp_path / f"db{i}")
        assert run(capsys, main, "makedb", "-i", f"{D}/{fname}", "-d",
                   db)[0] == 0
        dbs[i] = db
    printed = 0
    for k, maxdiv, limit in itertools.product((2, 99), (None, 1),
                                              (None, 1)):
        extra = ["--max-num-hits", str(k)]
        if maxdiv is not None:
            extra += ["--max-divergence", str(maxdiv)]
        if limit is not None:
            extra += ["--limit-per-sequence", str(limit)]
        r0 = run(capsys, main0, "query", "-d", dbs[1], "-q", f"{D}/{fname}",
                 *extra)
        r1 = run(capsys, main1, "query", "-d", dbs[0], "-q", f"{D}/{fname}",
                 *extra)
        assert r0[0] == r1[0] == 0, extra
        assert r1[1] == r0[1], extra
        printed += len(r1[1])
    assert printed


FUZZ_FLAGS = (["--max-num-hits", "99"],
              ["--max-num-hits", "40", "--max-divergence", "4"],
              ["--max-num-hits", "99", "--limit-per-sequence", "1"])


@pytest.mark.parametrize("extra", FUZZ_FLAGS)
def test_fuzz_kmode_with_switch(capsys, tmp_path, jax_runner_per_db, extra):
    """~3,000 x 60 bp with duplicate groups of 2, 5 and 40 (ties at the
    cutoff), batches of 128: the port's bytes under the switch equal
    smafa_tpu's under it and the port's own without it."""
    db_fa, q_fa = _fuzz_files(tmp_path, seed=len(extra), nq=300)
    db = str(tmp_path / "db")
    assert run(capsys, main0, "makedb", "-i", db_fa, "-d", db)[0] == 0
    argv = ["query", "-d", db, "-q", q_fa, "--batch-size", "128", *extra]
    want = run(capsys, main0, *argv)
    got = run(capsys, main1, *argv)
    assert want[0] == got[0] == 0
    assert got[1] == want[1] and want[1].count("\n") > 250
    with pytest.MonkeyPatch.context() as m:
        m.setenv(SWITCH, "0")
        assert run(capsys, main1, *argv)[1] == want[1]


@pytest.mark.parametrize("extra", FUZZ_FLAGS[1:])
def test_stream_kmode_with_switch(capsys, tmp_path, monkeypatch,
                                  jax_runner_per_db, extra):
    """The stream layout in 12 slabs of 256 rows, resident and streaming
    tiers, under the switch: the histogram summed over slabs gives
    smafa_tpu's bytes (its default layout, under the switch)."""
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    db_fa, q_fa = _fuzz_files(tmp_path, seed=5, nq=300)
    db = str(tmp_path / "db")
    assert run(capsys, main0, "makedb", "-i", db_fa, "-d", db)[0] == 0
    argv = ["query", "-d", db, "-q", q_fa, "--batch-size", "128", *extra]
    want = run(capsys, main0, *argv)[1]
    spy = HistSpy(monkeypatch, SlabStreamRunner)
    monkeypatch.setenv("SMAFA_TPU_LAYOUT", "stream")
    monkeypatch.setenv("SMAFA_TPU_SLAB_BYTES", str(256 * 60))
    for resident in ("1", "0"):
        monkeypatch.setenv("SMAFA_TPU_SLAB_RESIDENT", resident)
        code, got, err = run(capsys, main1, *argv, "-v")
        assert code == 0, err
        assert got == want and "12 slabs of 256 rows" in err
    assert spy.calls == {"_hist": 6, "_kstats": 0}  # 3 batches a tier
