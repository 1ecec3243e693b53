"""The port's cluster past the 31-bit key budget: ``_CentroidStore`` scans
its buffer in spans of ``keys.packing_span`` rows, one min_count launch a
span at the span's own shift, and merges (dist, index) with a strict
``<`` so earlier spans keep ties (smafa_tpu's ``min_scan`` pair carry,
distance.py:1371).

The port's key budget is cut in-process (the package has no knob for
it) to 10 index bits, so the 16,384-row buffer scans in spans of 1,024
rows. Against smafa_tpu's cluster, unpatched, byte for byte: the golden
files and a fuzz set of a few thousand centroids; ties across spans go to
the lowest index; a crash and ``--resume-state`` across the switch from
one launch to spans equals the straight run; and the span scan equals
``distance.min_count_reference`` over the whole buffer at the real
shift. At most 21 tests (see test_torch_cluster.py)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from test_torch_cluster import CLUSTER_FILES
from test_torch_cluster_engine import jax_cluster, port_cluster, write_fasta
from test_torch_topm_case import cut_budget

D = "tests/data"
SPAN_BITS = 10  # spans of 1,024 rows


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")


def cut_index_bits(monkeypatch, bits=SPAN_BITS):
    """Cut the port's key budget: no span wider than 2^bits rows packs."""
    from smafa_tpu_torch.ops import keys as K

    monkeypatch.setattr(K, "packing_shift", cut_budget(
        K.packing_shift, lambda shift, _dist_bits: shift <= bits))


@pytest.fixture
def scans(monkeypatch):
    """Each centroid scan the engine launches, as (centroids, buffer rows,
    span, the (n_valid, rows) of each of its min_count calls)."""
    from smafa_tpu_torch.engine import cluster

    out, calls = [], []
    real_mc, real_scan = cluster.min_count, cluster._CentroidStore.scan_async

    def min_count(q_emb, db_emb, zc, n_valid, *a, **kw):
        calls.append((n_valid, db_emb.shape[0]))
        return real_mc(q_emb, db_emb, zc, n_valid, *a, **kw)

    def scan_async(self, q_codes):
        del calls[:]
        handle = real_scan(self, q_codes)
        out.append((len(self), self.cap, self.span, list(calls)))
        return handle

    monkeypatch.setattr(cluster, "min_count", min_count)
    monkeypatch.setattr(cluster._CentroidStore, "scan_async", scan_async)
    return out


def check_spans(scans):
    """Every scan past the first launched one call per span that holds
    centroids, each over a 1,024-row span."""
    for n, cap, span, calls in scans:
        assert (cap, span) == (16384, 1 << SPAN_BITS)
        assert calls == [(min(span, n - off), span)
                         for off in range(0, n, span)]


def run(capsys, main, *argv):
    code = main(list(argv))
    cap = capsys.readouterr()
    assert code == 0, cap.err
    return cap.out


@pytest.mark.parametrize("fname", CLUSTER_FILES)
def test_golden_in_spans(capsys, monkeypatch, scans, fname):
    want = {d: run(capsys, main0, "cluster", "-i", f"{D}/{fname}", "-d", d)
            for d in ("0", "1", "2", "5")}
    cut_index_bits(monkeypatch)
    for d, out in want.items():
        assert run(capsys, main1, "cluster", "-i", f"{D}/{fname}", "-d",
                   d) == out
    assert scans
    check_spans(scans)


def _fuzz(seed, n, L):
    """Random windows over 3 letters and N, with exact duplicates and
    near copies of earlier records, so records promote and capture
    across the whole buffer."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 3, (n, L)).astype(np.uint8)
    seqs[rng.random((n, L)) < 0.03] = 4
    src = rng.integers(0, n, n // 4)
    dst = rng.integers(0, n, n // 4)
    keep = src < dst
    seqs[dst[keep]] = seqs[src[keep]]
    near = rng.integers(0, n, n // 4)
    dst = np.minimum(n - 1, near + rng.integers(1, n, near.size))
    seqs[dst] = seqs[near]
    seqs[dst, rng.integers(0, L, dst.size)] = rng.integers(0, 3, dst.size)
    return seqs


@pytest.mark.parametrize("seed,maxdiv,bs", [(0, 1, 300), (1, 2, 500),
                                            (2, 0, 1000)])
def test_fuzz_in_spans(tmp_path, monkeypatch, scans, seed, maxdiv, bs):
    """Inputs of 4,000-5,000 centroids: 3 to 5 spans a late batch."""
    fa = write_fasta(tmp_path / "in.fna", _fuzz(seed, 6000, 16))
    want = jax_cluster(fa, maxdiv, batch_size=bs)
    cut_index_bits(monkeypatch)
    assert port_cluster(fa, maxdiv, batch_size=bs) == want
    check_spans(scans)
    assert max(len(calls) for *_, calls in scans) >= 3


def _store(codes):
    import torch

    from smafa_tpu_torch.engine.cluster import _CentroidStore

    return _CentroidStore.from_codes(codes, torch.device("cpu"))


def test_ties_across_spans_take_lowest_index(monkeypatch, scans):
    """Equal minima in two or three spans: the lowest index wins, also
    where the first span holds no minimum; a unique minimum in the last,
    partial span is found."""
    rng = np.random.default_rng(7)
    L = 24
    codes = rng.integers(0, 4, (2900, L), dtype=np.uint8)
    codes[[1500, 2500]] = codes[100]           # spans 0, 1, 2
    codes[2100] = codes[1200]                  # spans 1, 2
    q = codes[[100, 1200, 2899, 2500]].copy()
    q[3, 0] = (q[3, 0] + 1) % 4                # dist 1 to 100, 1500, 2500
    cut_index_bits(monkeypatch)
    store = _store(codes)
    assert (store.cap, store.span, store.shift) == (16384, 1024, 10)
    dist, idx = store.scan_fetch(store.scan_async(q))
    np.testing.assert_array_equal(idx, [100, 1200, 2899, 100])
    np.testing.assert_array_equal(dist, [0, 0, 0, 1])
    assert scans[0][3] == [(1024, 1024), (1024, 1024), (852, 1024)]


def test_span_scan_equals_whole_buffer_reference(monkeypatch, scans):
    """(dist, idx) of the span scan equal ``min_count_reference`` over the
    whole buffer at its real shift, unpacked."""
    import torch

    from smafa_tpu_torch.ops import distance as Dt
    from smafa_tpu_torch.ops import keys as K

    rng = np.random.default_rng(11)
    L, n = 30, 3333
    codes = rng.integers(0, 5, (n, L), dtype=np.uint8)
    codes[rng.integers(0, n, 300)] = codes[rng.integers(0, n, 300)]
    q = codes[rng.integers(0, n, 400)].copy()
    mut = rng.random(q.shape) < 0.2
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    shift = K.packing_shift(L, 16384)
    cut_index_bits(monkeypatch)
    store = _store(codes)
    got = store.scan_fetch(store.scan_async(q))
    check_spans(scans)
    assert len(scans[0][3]) == 4
    q_emb = Dt.expand_embed_query(torch.from_numpy(q), L)
    (key,) = Dt.min_count_reference(q_emb, store.db_emb, store.zc, n, L,
                                    shift, with_count=False)
    for g, w in zip(got, Dt.unpack_min_key(key, shift)):
        np.testing.assert_array_equal(g, w.numpy())


def test_under_budget_one_launch(scans):
    """While the buffer's keys pack, one min_count launch over the whole
    buffer at its own shift, as before spans existed."""
    store = _store(np.random.default_rng(3).integers(
        0, 4, (20000, 60), dtype=np.uint8))
    assert (store.cap, store.span, store.shift) == (32768, 32768, 15)
    store.scan_fetch(store.scan_async(np.zeros((5, 60), np.uint8)))
    assert scans == [(20000, 32768, 32768, [(20000, 32768)])]


@pytest.mark.parametrize("fail_at", [3, 7])
def test_resume_across_span_switch(tmp_path, monkeypatch, scans, fail_at):
    """A 512-row first buffer and 10 index bits: the scan is one launch
    while the buffer holds 512 or 1,024 rows and spans of 1,024 from
    2,048 on. A crash before (write 3) or after (write 7) the switch,
    then ``cluster --resume-state`` through the CLI: the bytes of the
    straight run, which are smafa_tpu's."""
    import torch

    from smafa_tpu_torch.engine import cluster
    from smafa_tpu_torch.utils.testing import CrashError, CrashyFile

    fa = write_fasta(tmp_path / "in.fna", _fuzz(20 + fail_at, 2600, 14))
    want = jax_cluster(fa, 1, batch_size=256)
    monkeypatch.setattr(cluster, "INITIAL_CAPACITY", 512)
    cut_index_bits(monkeypatch)
    assert port_cluster(fa, 1, batch_size=256) == want
    state, outp = tmp_path / "st.json", tmp_path / "o.tsv"
    with open(outp, "w") as f:
        with pytest.raises(CrashError):
            cluster.cluster(fa, 1, torch.device("cpu"),
                            out=CrashyFile(f, fail_at=fail_at),
                            batch_size=256, resume_state=state)
    n_at_crash = json.loads(state.read_text())["n_centroids"]
    assert (n_at_crash < 1024) == (fail_at == 3)
    del scans[:]
    assert main1(["cluster", "-i", fa, "-d", "1", "--batch-size", "256",
                  "-o", str(outp), "--resume-state", str(state),
                  "--quiet"]) == 0
    assert outp.read_text() == want
    # resumed from the sidecar: one launch first (a buffer of 512 or
    # 1,024 rows) when the crash came before the switch
    one_launch = [span == cap for _, cap, span, _ in scans]
    assert one_launch[0] == (fail_at == 3) and not one_launch[-1]
    assert scans[-1][2] == 1024 and len(scans[-1][3]) >= 2
