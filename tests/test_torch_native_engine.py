"""The port's engines on the native runtime: the native emit tiers and
dedup equal their Python tiers, and makedb, query (best-hit and K-mode),
cluster and count through the CLI print the same bytes with the native
library and under SMAFA_TPU_NO_NATIVE=1, equal to smafa_tpu's, on every
FASTX file of tests/data and on seeded fuzz dbs; on the native path the
parse, the emit and the dedup really run natively."""

from __future__ import annotations

import io
import types

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu.engine import query as Q0
from smafa_tpu_torch.cli import main as main1
from smafa_tpu_torch.io.db import load_db
from smafa_tpu_torch.native import ingest, load
from test_torch_query import _fuzz_files

D = "tests/data"
FASTX = ["random_3_2.fna", "degenerate.fna", "random_3_2_one_repeated.fna",
         "cluster_best_hit_changes.fna", "cluster_bug1.fna",
         "cluster_dummy1.fna", "subjects.fa"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")


def engines():
    """The port's cluster and query engines, imported when a test runs:
    collecting must not load torch (tests/torch_gpu_common.py says why)."""
    from smafa_tpu_torch.engine import cluster, query

    return cluster, query


def run(capsys, main, *argv):
    code = main(list(argv))
    return code, capsys.readouterr().out


def opt_out(monkeypatch, on: bool):
    if on:
        monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("SMAFA_TPU_NO_NATIVE", raising=False)


def port_both_ways(capsys, monkeypatch, *argv):
    """(rc, stdout) of the port's CLI natively, then under the opt-out."""
    got = []
    for on in (False, True):
        opt_out(monkeypatch, on)
        got.append(run(capsys, main1, *argv))
    opt_out(monkeypatch, False)
    return got


def fuzz_db(tmp_path, fmt):
    db_fa, _ = _fuzz_files(tmp_path, seed=2, n=700, nq=10)
    db = str(tmp_path / f"db.{fmt}")
    assert main1(["makedb", "-i", db_fa, "-d", db, "--format", fmt]) == 0
    return types.SimpleNamespace(windows=load_db(db), seq_len=60)


def emit(mod, qnums, subj, d, db) -> tuple[bytes, str]:
    """Bytes through a file-like text stream, and text through a StringIO."""
    raw = io.BytesIO()
    text = io.TextIOWrapper(raw, encoding="utf-8", newline="")
    mod._emit_bulk(text, qnums, subj, d, db)
    text.flush()
    s = io.StringIO()
    mod._emit_bulk(s, qnums, subj, d, db)
    return raw.getvalue(), s.getvalue()


@pytest.mark.parametrize("fmt", ["postcard", "native"])
def test_emit_tiers_equal(tmp_path, monkeypatch, fmt):
    """The codes tier, the blob tier and the Python tier write the same
    bytes as smafa_tpu's emit, on hit arrays of the types the scan gives
    (torch-derived int64 subjects and distances)."""
    import torch

    _, Q1 = engines()
    db = fuzz_db(tmp_path, fmt)
    rng = np.random.default_rng(5)
    n = 5000
    qnums = np.sort(rng.integers(0, 10**9, n)).astype(np.int64)
    subj = torch.from_numpy(rng.integers(0, 700, n)).numpy()
    d = torch.from_numpy(rng.integers(0, 61, n)).numpy()
    want = emit(Q0, qnums, subj, d, db)
    assert want[0].decode() == want[1] and want[1].count("\n") == n

    calls = []
    codes_tier = ingest.format_hits_tsv_codes

    def spy(*a):
        calls.append(codes_tier(*a))
        return calls[-1]

    monkeypatch.setattr(ingest, "format_hits_tsv_codes", spy)
    assert emit(Q1, qnums, subj, d, db) == want
    assert len(calls) == 2 and None not in calls  # the db's codes took it
    monkeypatch.setattr(ingest, "format_hits_tsv_codes", lambda *a: None)
    assert emit(Q1, qnums, subj, d, db) == want  # blob tier
    monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    assert emit(Q1, qnums, subj, d, db) == want  # Python tier


def test_emit_subject_out_of_range_raises(tmp_path):
    _, Q1 = engines()
    db = fuzz_db(tmp_path, "native")
    for bad in (-1, 700):
        with pytest.raises(IndexError, match="subject index out of range"):
            Q1._emit_bulk(io.StringIO(), np.zeros(2, np.int64),
                          np.array([0, bad], np.int64), np.zeros(2, np.int64),
                          db)


def test_dedup_native_equals_python(monkeypatch):
    rng = np.random.default_rng(7)
    pool = rng.integers(0, 5, (300, 31), dtype=np.uint8)
    batches = [pool[rng.integers(0, 300, k)] for k in (1, 50, 400, 0, 77)]
    C1, _ = engines()
    native = C1._Dedup()
    assert native._h is not None
    monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    plain = C1._Dedup()
    assert plain._h is None
    seen = set()
    for b in batches:
        want = np.array([not (r.tobytes() in seen or seen.add(r.tobytes()))
                         for r in b], bool)
        np.testing.assert_array_equal(native.filter(b), want)
        np.testing.assert_array_equal(plain.filter(b[:, :]), want)


def test_native_spies_on_the_engines(monkeypatch, capsys):
    """Natively, a query parses with parse_buffer and emits with the codes
    tier, and a cluster parses with parse_buffer and dedups with
    dedup_filter."""
    calls = {"parse_buffer": 0, "format_hits_tsv_codes": 0}
    for name in calls:
        fn = getattr(ingest, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ingest, name, spy)
    lib = load()
    dedup_filter = lib.dedup_filter
    dedups = []
    monkeypatch.setattr(lib, "dedup_filter",
                        lambda *a: dedups.append(a[2]) or dedup_filter(*a))
    assert run(capsys, main1, "query", "-d", f"{D}/random_3_2.fna.smafadb",
               "-q", f"{D}/random_3_2.fna")[0] == 0
    assert calls == {"parse_buffer": 1, "format_hits_tsv_codes": 1}
    assert run(capsys, main1, "cluster", "-i", f"{D}/cluster_bug1.fna",
               "-d", "2")[0] == 0
    assert calls["parse_buffer"] == 2 and dedups == [3]


@pytest.mark.parametrize("fname", FASTX)
def test_cli_native_and_opt_out_equal_jax(capsys, monkeypatch, tmp_path,
                                          fname):
    fa = f"{D}/{fname}"
    for fmt in ("postcard", "native"):
        dbs = []
        for i, main in enumerate((main0, main1)):
            db = tmp_path / f"db{i}.{fmt}"
            assert main(["makedb", "-i", fa, "-d", str(db), "--format", fmt,
                         "--quiet"]) == 0
            dbs.append(db.read_bytes())
        opt_out(monkeypatch, True)
        assert main1(["makedb", "-i", fa, "-d", str(tmp_path / "db2"),
                      "--format", fmt, "--quiet"]) == 0
        opt_out(monkeypatch, False)
        assert dbs[0] == dbs[1] == (tmp_path / "db2").read_bytes()
        db = str(tmp_path / f"db1.{fmt}")
        for extra in ([], ["--max-num-hits", "3"],
                      ["--max-num-hits", "5", "--limit-per-sequence", "1"]):
            argv = ["query", "-d", db, "-q", fa, "--batch-size", "2", *extra]
            want = run(capsys, main0, *argv)
            assert port_both_ways(capsys, monkeypatch, *argv) == [want, want]
    for maxdiv in ("0", "3"):
        argv = ["cluster", "-i", fa, "-d", maxdiv, "--batch-size", "2"]
        want = run(capsys, main0, *argv)
        assert want[0] == 0
        assert port_both_ways(capsys, monkeypatch, *argv) == [want, want]


def test_cli_count_native_and_opt_out_equal_jax(capsys, monkeypatch):
    argv = ["count", "-i", *(f"{D}/{f}" for f in [*FASTX, "random_30_4.fq.gz"])]
    want = run(capsys, main0, *argv)
    assert want[0] == 0 and '"num_reads"' in want[1]
    assert port_both_ways(capsys, monkeypatch, *argv) == [want, want]


@pytest.mark.parametrize("seed", [0, 1])
def test_cli_fuzz_native_and_opt_out_equal_jax(capsys, monkeypatch, tmp_path,
                                               seed):
    db_fa, q_fa = _fuzz_files(tmp_path, seed=seed, n=1500, nq=200)
    outs = []
    for i, main in enumerate((main0, main1)):
        db = str(tmp_path / f"db{i}")
        assert main(["makedb", "-i", db_fa, "-d", db]) == 0
        outs.append(run(capsys, main, "query", "-d", db, "-q", q_fa,
                        "--batch-size", "64", "--max-num-hits", "7"))
    assert outs[0][1] and outs[0] == outs[1]
    db = str(tmp_path / "db1")
    for extra in ([], ["--max-num-hits", "7"]):
        argv = ["query", "-d", db, "-q", q_fa, "--batch-size", "64", *extra]
        nat, plain = port_both_ways(capsys, monkeypatch, *argv)
        assert nat == plain and nat[0] == 0 and nat[1]
    argv = ["cluster", "-i", q_fa, "-d", "4"]
    want = run(capsys, main0, *argv)
    assert port_both_ways(capsys, monkeypatch, *argv) == [want, want]


def test_cluster_read_at_ceiling_keeps_the_schedule(tmp_path):
    """The cluster reads in batches of the ceiling and cuts them: the
    same batches, row for row, as reading at the batch size, width
    changes and the file's end included."""
    rng = np.random.default_rng(4)
    fa = tmp_path / "w.fna"
    with open(fa, "w") as f:
        for i, L in enumerate([7] * 300 + [9] * 45 + [7] * 130):
            f.write(f">r{i}\n{''.join('ACGT'[c] for c in rng.integers(0, 4, L))}\n")
    from smafa_tpu_torch.io.fastx import read_encoded_batches

    C1, _ = engines()
    want = [(i, r, c.tolist()) for i, r, c in read_encoded_batches(fa, 16)]
    got = [(i, r, c.tolist()) for i, r, c in C1._split_batches(
        read_encoded_batches(fa, 16 * 8), 16)]
    assert got == want and len(want) == 31
