"""The runner, cluster and query engines on the card against the CPU,
resumed runs included, and the wrappers' operand checks on the card. The kernels' card tests
are in tests/test_torch_gpu_min2.py, tests/test_torch_gpu_compact.py,
tests/test_torch_gpu_kstats.py and tests/test_torch_gpu_min_count.py.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_gpu_common import cuda, operands  # noqa: F401

pytestmark = pytest.mark.gpu


def _cluster_text(g, path, device, max_div, batch_size):
    import io

    buf = io.StringIO()
    g.CL.cluster(path, max_div, device, out=buf, batch_size=batch_size)
    return buf.getvalue()


def test_cluster_on_card_equals_cpu(cuda, tmp_path):
    """The cluster op on the card prints what it prints on the CPU, on
    mutated copies of 300 ancestors and on 20,000 random records that
    nearly all promote, so the centroid buffer doubles past 16384."""
    rng = np.random.default_rng(1)
    anc = rng.integers(0, 4, (300, 60), dtype=np.uint8)
    mutated = anc[rng.integers(0, 300, 20000)]
    k = rng.integers(0, 5, 20000)
    for s in range(4):
        sel = np.nonzero(k > s)[0]
        mutated[sel, rng.integers(0, 60, sel.size)] = rng.integers(
            0, 5, sel.size).astype(np.uint8)
    cases = [(mutated, 5, (None, 777)),
             (rng.integers(0, 4, (20000, 20), dtype=np.uint8), 1, (2048,))]
    for i, (codes, max_div, batch_sizes) in enumerate(cases):
        path = tmp_path / f"in{i}.fna"
        with open(path, "w") as f:
            for j, row in enumerate(np.frombuffer(b"ACGTN", np.uint8)[codes]):
                f.write(f">s{j}\n{row.tobytes().decode()}\n")
        for bs in batch_sizes:
            before = cuda.MC.launches
            got = _cluster_text(cuda, path, cuda.dev, max_div, bs)
            assert cuda.MC.launches > before
            want = _cluster_text(cuda, path, cuda.torch.device("cpu"), max_div,
                                 bs)
            assert got == want and got, (i, bs)


def test_runner_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, (3000, 60)).astype(np.uint8)
    codes = np.concatenate([base, base[:500], base[:50], base[:50]])
    q = codes[rng.integers(0, codes.shape[0], 1000)].copy()
    q[::3, :3] = 0
    for maxdiv in (None, 0, 2):
        got = cuda.ScanRunner(codes, 60, cuda.dev).best_hit(q, maxdiv)
        want = cuda.ScanRunner(codes, 60, cuda.torch.device("cpu")).best_hit(
            q, maxdiv)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)


def _query_files(tmp_path):
    """A 20,000-window 60 bp db with duplicate groups (makedb'd) and
    1,500 reads mutated off it: (db path, query path)."""
    from smafa_tpu_torch.engine.makedb import makedb

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (20000, 60), dtype=np.uint8)
    codes[rng.integers(0, 20000, 3000)] = codes[rng.integers(0, 20, 3000)]
    q = codes[rng.integers(0, 20000, 1500)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    for name, m in (("db.fna", codes), ("q.fna", q)):
        with open(tmp_path / name, "w") as f:
            for i, row in enumerate(letters[m]):
                f.write(f">{name[0]}{i}\n{row.tobytes().decode()}\n")
    db = str(tmp_path / "db")
    makedb(str(tmp_path / "db.fna"), db)
    return db, str(tmp_path / "q.fna")


def _query_text(cuda, db, q, dev, **kw) -> str:
    import io

    buf = io.StringIO()
    cuda.Q.query(db, q, dev, out=buf, **kw)
    return buf.getvalue()


def test_kmode_query_on_card_equals_cpu(cuda, tmp_path):
    """K-mode through the query engine on the card prints what it prints
    on the CPU: at K = 99 (ties at the cutoff), with --max-divergence and
    --limit-per-sequence, over two batches and over three (each batch's
    cutoff passes run on the side stream while the batch before is
    compacted)."""
    db, q = _query_files(tmp_path)
    for bs in (1024, 512):
        for kw in ({"max_num_hits": 99},
                   {"max_num_hits": 99, "max_divergence": 5,
                    "limit_per_sequence": 1}):
            before = cuda.KS.launches
            got = _query_text(cuda, db, q, cuda.dev, batch_size=bs, **kw)
            assert (cuda.KS.launches - before
                    == -(-1500 // bs) * cuda.K.kstats_steps(60))
            want = _query_text(cuda, db, q, cuda.torch.device("cpu"),
                               batch_size=bs, **kw)
            assert got == want and got, (bs, kw)


def test_best_hit_query_batches_on_card_equal_cpu(cuda, tmp_path):
    """Best-hit through the query engine on the card, over three batches
    (phase A of each on the side stream), prints what it prints on the
    CPU, with and without --max-divergence."""
    db, q = _query_files(tmp_path)
    for kw in ({}, {"max_divergence": 3}):
        before = cuda.M.launches
        got = _query_text(cuda, db, q, cuda.dev, batch_size=512, **kw)
        assert cuda.M.launches - before == 3
        want = _query_text(cuda, db, q, cuda.torch.device("cpu"),
                           batch_size=512, **kw)
        assert got == want and got, kw


def _crash_then_resume(run, path, state, fail_at):
    """run(out, resume_state) crashed at write ``fail_at`` into ``path``,
    then run again on it: the file's text after the resume."""
    from smafa_tpu_torch.utils.testing import CrashError, CrashyFile

    with open(path, "w") as f:
        with pytest.raises(CrashError):
            run(CrashyFile(f, fail_at=fail_at), state)
    with open(path, "a+") as f:
        run(f, state)
    return path.read_text()


def test_resumed_query_on_card_equals_cpu(cuda, tmp_path):
    """Best-hit and K-mode queries on the card, crashed in their second
    batch (a torn write) and resumed from the state file, print what one
    straight run on the CPU prints."""
    db, q = _query_files(tmp_path)
    for i, kw in enumerate(({}, {"max_num_hits": 99, "max_divergence": 5})):
        want = _query_text(cuda, db, q, cuda.torch.device("cpu"),
                           batch_size=512, **kw)

        def run(out, state):
            cuda.Q.query(db, q, cuda.dev, out=out, batch_size=512,
                         resume_state=state, **kw)

        got = _crash_then_resume(run, tmp_path / f"o{i}.tsv",
                                 tmp_path / f"st{i}.json", fail_at=2)
        assert got == want and got, kw


def test_resumed_cluster_on_card_equals_cpu(cuda, tmp_path):
    """cluster on the card, crashed after some batches and resumed: its
    centroid sidecar goes back onto the card (past 16,384 rows in the
    second case), and the output is what one straight run on the CPU
    prints."""
    rng = np.random.default_rng(3)
    anc = rng.integers(0, 4, (300, 60), dtype=np.uint8)
    mutated = anc[rng.integers(0, 300, 20000)]
    sel = rng.integers(0, 20000, 30000)
    mutated[sel, rng.integers(0, 60, sel.size)] = rng.integers(0, 4, sel.size)
    cases = [(mutated, 5, None, 3),
             (rng.integers(0, 4, (20000, 20), dtype=np.uint8), 1, 4100, 5)]
    for i, (codes, max_div, bs, fail_at) in enumerate(cases):
        path = tmp_path / f"in{i}.fna"
        with open(path, "w") as f:
            for j, row in enumerate(np.frombuffer(b"ACGTN", np.uint8)[codes]):
                f.write(f">s{j}\n{row.tobytes().decode()}\n")
        want = _cluster_text(cuda, path, cuda.torch.device("cpu"), max_div, bs)

        def run(out, state):
            cuda.CL.cluster(path, max_div, cuda.dev, out=out, batch_size=bs,
                            resume_state=state)

        state = tmp_path / f"st{i}.json"
        got = _crash_then_resume(run, tmp_path / f"o{i}.tsv", state, fail_at)
        assert got == want and got, i
        if bs is not None:
            side = np.load(tmp_path / f"st{i}.json.centroids.npy")
            assert side.shape[0] > 16384


def test_cuda_operands_checked(cuda):
    torch = cuda.torch
    emb, zc, q_emb, shift = operands(cuda, 13, 200, 8, 1)
    with pytest.raises(TypeError):
        cuda.M.min2(q_emb.to(torch.int32), emb, zc, 13, shift)
    with pytest.raises(ValueError):
        cuda.M.min2(q_emb[:, :16], emb, zc, 13, shift)
    with pytest.raises(ValueError):
        cuda.C.compact_mask(q_emb, emb, zc, torch.zeros(
            3, dtype=torch.int32, device=cuda.dev), 13)
    with pytest.raises(ValueError):
        cuda.MC.min_count(q_emb, emb, zc, emb.shape[0] + 1, 13, shift)
    with pytest.raises(ValueError):
        cuda.KS.kstats(q_emb, emb, zc, torch.zeros(
            (3, 8), dtype=torch.int32, device=cuda.dev), emb.shape[0], 13)
