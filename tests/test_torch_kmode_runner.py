"""K-mode on the seeded heavy-tie fuzz db and through the runner, on the
CPU: smafa_tpu_torch prints what smafa_tpu and the literal transcription
of the reference (``oracle_query``) print, in one batch or many; a row
above COMPACT_MAX takes the host path; the port's ``kmode_flat`` equals
smafa_tpu's ``ScanRunner.kmode_flat`` on the same codes; a compaction
that disagrees with the kstats counts raises."""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1
from test_fuzz_parity import oracle_query
from test_torch_kmode import jax_runner_per_db  # noqa: F401 (fixture)
from test_torch_query import _fuzz_files


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")


def run(capsys, main, *argv):
    code = main(list(argv))
    return code, capsys.readouterr().out


def _fasta_seqs(path):
    with open(path) as f:
        return [line.strip() for line in f if not line.startswith(">")]


def _query_both(capsys, tmp_path, db_fa, q_fa, *extra):
    outs = []
    for i, main in enumerate((main0, main1)):
        db = str(tmp_path / f"db{i}")
        if not (tmp_path / f"db{i}").exists():
            assert run(capsys, main, "makedb", "-i", db_fa, "-d", db)[0] == 0
        code, out = run(capsys, main, "query", "-d", db, "-q", q_fa, *extra)
        assert code == 0
        outs.append(out)
    return outs


@pytest.mark.parametrize("k", [2, 5, 99])
def test_kmode_fuzz_matches_jax_and_oracle(capsys, tmp_path, jax_runner_per_db,
                                           k):
    """~3,000 x 60 bp with duplicate groups of 2, 5 and 40: ties at the
    cutoff; limits 1 and 2 cut the duplicate runs. The oracle checks the
    first 60 reads."""
    db_fa, q_fa = _fuzz_files(tmp_path, seed=k, nq=200)
    db_seqs, q_seqs = _fasta_seqs(db_fa), _fasta_seqs(q_fa)
    for maxdiv, limit in ((None, None), (4, None), (None, 1), (3, 2)):
        extra = ["--max-num-hits", str(k), "--batch-size", "64"]
        if maxdiv is not None:
            extra += ["--max-divergence", str(maxdiv)]
        if limit is not None:
            extra += ["--limit-per-sequence", str(limit)]
        o0, o1 = _query_both(capsys, tmp_path, db_fa, q_fa, *extra)
        assert o1 == o0 and o1, extra
        head = "".join(line + "\n" for line in o1.splitlines()
                       if int(line.split("\t", 1)[0]) < 60)
        assert head == oracle_query(db_seqs, q_seqs[:60], maxdiv, k, limit), extra
        if maxdiv is None and limit is None and k == 99:
            # cutoff ties: some read prints more than K lines
            qnums = [line.split("\t", 1)[0] for line in o1.splitlines()]
            assert max(qnums.count(x) for x in set(qnums)) > k


@pytest.mark.parametrize("batch_size", [1, 7])
def test_kmode_multi_batch(capsys, tmp_path, batch_size):
    db_fa, q_fa = _fuzz_files(tmp_path, seed=3, n=400, nq=30)
    extra = ["--max-num-hits", "5", "--max-divergence", "6",
             "--limit-per-sequence", "1"]
    o0, o1 = _query_both(capsys, tmp_path, db_fa, q_fa, *extra,
                         "--batch-size", str(batch_size))
    one = _query_both(capsys, tmp_path, db_fa, q_fa, *extra)[1]
    assert o1 == o0 == one and one


def test_kmode_giant_row_takes_host_path(capsys, tmp_path, monkeypatch):
    """With COMPACT_MAX at 50, rows printing a duplicate group of 40 plus
    more go through the host enumeration, and groups split."""
    from smafa_tpu_torch.parallel import hitops, runner

    db_fa, q_fa = _fuzz_files(tmp_path, seed=4, n=600, nq=40)
    extra = ["--max-num-hits", "99", "--batch-size", "16"]
    want = _query_both(capsys, tmp_path, db_fa, q_fa, *extra)[0]
    calls = {"host": 0}
    real = hitops.HitModesMixin._host_enumerate_row

    def spy(self, *a):
        calls["host"] += 1
        return real(self, *a)

    monkeypatch.setattr(hitops, "COMPACT_MAX", 50)
    monkeypatch.setattr(runner.ScanRunner, "_host_enumerate_row", spy)
    code, out = run(capsys, main1, "query", "-d", str(tmp_path / "db1"),
                    "-q", q_fa, *extra)
    assert code == 0 and out == want
    assert calls["host"] > 0


def _runner_case():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, (300, 60)).astype(np.uint8)
    codes = np.concatenate([base, base[:40], base[:7], base[:7]])
    q = codes[rng.integers(0, codes.shape[0], 70)].copy()
    q[::4, :5] = 0
    return codes, q


def test_kmode_flat_matches_scan_runner():
    import torch

    from smafa_tpu.parallel.sharded import ScanRunner, build_mesh
    from smafa_tpu_torch.parallel.runner import ScanRunner as TorchRunner

    codes, q = _runner_case()
    want_runner = ScanRunner(codes, 60, mesh=build_mesh(1, 1))
    got_runner = TorchRunner.from_codes(codes, 60, torch.device("cpu"))
    for k, maxdiv in ((2, None), (99, 30), (500, None), (7, 0)):
        want = want_runner.kmode_flat(q, k, maxdiv)
        got = got_runner.kmode_flat(q, k, maxdiv)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_kmode_count_mismatch_raises(monkeypatch):
    import torch

    from smafa_tpu_torch.parallel.runner import ScanRunner

    codes, q = _runner_case()
    r = ScanRunner(codes, 60, torch.device("cpu"))
    real = ScanRunner._compactd

    def drop_one(self, *a):
        rows, idx, dv, counts = real(self, *a)
        counts = counts.copy()
        counts[0] -= 1
        return rows[1:], idx[1:], dv[1:], counts

    monkeypatch.setattr(ScanRunner, "_compactd", drop_one)
    with pytest.raises(RuntimeError, match="disagree"):
        r.kmode_flat(q, 5, None)
