"""The port's query-stream split (``smafa_tpu_torch.parallel.querysplit``)
against smafa_tpu's: the byte ranges and the range parses equal the
originals', and the split protocol, run as simulated processes in
threads over ``ThreadComm`` (a barrier exchanger in place of
``parallel.comm.Comm``, as tests/test_querysplit.py's ``_FakeCluster``
stands in for process_allgather), yields the single stream's batches
byte for byte, with the deferred errors' order and texts and the
resume skips. ``ThreadComm`` also serves tests/test_torch_sharded.py,
tests/test_torch_ring.py and tests/test_torch_col.py."""

from __future__ import annotations

import gzip
import threading

import numpy as np
import pytest

from smafa_tpu.parallel import querysplit as QS0

ALPHA = np.array(list("ACGTN"))


class ThreadComm:
    """Rank ``rank`` of ``cluster``'s simulated processes (threads): the
    collectives of ``parallel.comm.Comm`` on CPU tensors, each one
    barrier-synchronised exchange of every rank's tensor."""

    device_nccl = False

    def __init__(self, cluster: "ThreadCluster", rank: int):
        self._c, self.rank, self.size = cluster, rank, cluster.n

    def _exchange(self, t):
        c = self._c
        c.slots[self.rank] = t.clone()
        c.barrier.wait()
        out = list(c.slots)
        c.barrier.wait()  # every rank has read the slots
        return out

    def all_gather(self, t):
        out = self._exchange(t)
        assert len({tuple(x.shape) for x in out}) == 1, "shapes differ"
        return out

    def all_reduce(self, t, op):
        import torch

        x = torch.stack(self.all_gather(t))
        return {"sum": x.sum(0), "min": x.amin(0),
                "max": x.amax(0)}[op].to(t.dtype)

    def broadcast(self, t, src):
        return self._exchange(t)[src].clone()

    def gather_var(self, t):
        return self._exchange(t)

    def rotate(self, t):
        return self._exchange(t)[(self.rank - 1) % self.size]


class ThreadCluster:
    def __init__(self, n: int):
        self.n = n
        # a rank whose peer failed stops waiting (BrokenBarrierError)
        self.barrier = threading.Barrier(n, timeout=30)
        self.slots = [None] * n


def run_ranks(n: int, fn):
    """fn(comm) in n threads, one simulated rank each: the results and
    the exceptions (None where there was none), in rank order."""
    cluster = ThreadCluster(n)
    res, errs = [None] * n, [None] * n

    def work(r):
        try:
            res[r] = fn(ThreadComm(cluster, r))
        except BaseException as e:  # noqa: BLE001 (reported to the test)
            errs[r] = e

    ts = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive(), "a simulated rank hangs"
    return res, errs


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


def _write_fastq(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            # every third quality line starts with '@'
            f.write(f"@s{i}\n{s}\n+\n{('@' if i % 3 == 0 else 'I') * len(s)}\n")


def _rand_seqs(rng, n, L):
    return ["".join(ALPHA[rng.integers(0, 4, L)]) for _ in range(n)]


@pytest.fixture
def QS():
    from smafa_tpu_torch.parallel import querysplit

    return querysplit


@pytest.mark.parametrize("fmt", [b">", b"@"])
def test_byte_ranges_equal_smafa_tpu(tmp_path, QS, fmt):
    rng = np.random.default_rng(0)
    path = tmp_path / "q"
    (_write_fasta if fmt == b">" else _write_fastq)(
        path, _rand_seqs(rng, 157, 33))
    assert QS.split_format(path) == QS0.split_format(path) == fmt
    for P in (1, 2, 3, 4, 8, 200):
        bounds = QS.byte_ranges(path, P, fmt)
        assert bounds == QS0.byte_ranges(path, P, fmt)
        for p in range(P):
            a = QS._parse_slice(path, bounds[p], bounds[p + 1])
            b = QS0._parse_slice(path, bounds[p], bounds[p + 1])
            assert (a.n_ok, a.length, a.error_text) == (
                b.n_ok, b.length, b.error_text)
            np.testing.assert_array_equal(a.codes, b.codes)


def test_split_format_gzip_is_none(tmp_path, QS):
    gz = tmp_path / "q.fq.gz"
    with gzip.open(gz, "wt") as f:
        f.write("@a\nACGT\n+\nIIII\n")
    assert QS.split_format(gz) is None
    assert QS.split_format(tmp_path / "missing") is None


@pytest.mark.parametrize("native", [True, False])
def test_parse_slice_defers_errors(tmp_path, monkeypatch, QS, native):
    if not native:
        monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    fa = tmp_path / "bad.fna"
    fa.write_text(">a\nACGT\n>b\nACXT\n>c\nACGT\n")
    rp = QS._parse_slice(fa, 0, fa.stat().st_size)
    want = QS0._parse_slice(fa, 0, fa.stat().st_size)
    assert rp.n_ok == 1 and "88" in rp.error_text
    assert rp.error_text == want.error_text
    np.testing.assert_array_equal(rp.codes, want.codes)


def test_parse_slice_defers_a_failed_parse(tmp_path, QS):
    """A malformed FASTQ range fails its parse outright; the port defers
    that error too (no valid prefix), so no peer waits for the range."""
    fq = tmp_path / "bad.fq"
    fq.write_text("@a\nACGT\nIIII\n")
    rp = QS._parse_slice(fq, 0, fq.stat().st_size)
    assert rp.n_ok == 0 and "FASTQ" in rp.error_text


def _split(QS, path, batch_size, skip=0, n=2):
    """The split's batches on every simulated rank; asserts that every
    rank saw the same batches and the same error. Returns (batches,
    error) of rank 0."""
    def fn(comm):
        got, err = [], None
        gen = QS.split_encoded_batches(path, batch_size, skip_records=skip,
                                       comm=comm)
        assert gen is not None
        try:
            for ids, raws, codes in gen:
                assert ids is None and raws is None
                got.append(np.array(codes))
        except Exception as e:  # noqa: BLE001 (compared across ranks)
            err = e
        return got, err

    res, errs = run_ranks(n, fn)
    assert errs == [None] * n
    for got, err in res[1:]:
        assert len(got) == len(res[0][0])
        for a, b in zip(got, res[0][0]):
            np.testing.assert_array_equal(a, b)
        assert str(err) == str(res[0][1])
    return res[0]


def _single(path, batch_size, skip=0):
    from smafa_tpu_torch.io.fastx import read_encoded_batches

    got, err = [], None
    try:
        for _i, _r, c in read_encoded_batches(path, batch_size=batch_size,
                                              skip_records=skip):
            got.append(c)
    except Exception as e:  # noqa: BLE001 (compared with the split's)
        err = e
    return got, err


@pytest.mark.parametrize("n,fmt", [(2, b">"), (3, b">"), (2, b"@"),
                                   (5, b"@")])
def test_split_protocol_matches_single_stream(tmp_path, QS, n, fmt):
    rng = np.random.default_rng(3)
    path = tmp_path / "q"
    (_write_fasta if fmt == b">" else _write_fastq)(
        path, _rand_seqs(rng, 101, 24))
    got, err = _split(QS, path, 16, n=n)
    want, _ = _single(path, 16)
    assert err is None
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_split_protocol_resume_skip(tmp_path, QS):
    rng = np.random.default_rng(5)
    fa = tmp_path / "q.fna"
    _write_fasta(fa, _rand_seqs(rng, 60, 12))
    for skip in (0, 7, 30, 59, 60):
        got, err = _split(QS, fa, 8, skip=skip)
        want, _ = _single(fa, 8, skip=skip)
        assert err is None
        if skip >= 60:
            assert got == []
        else:
            np.testing.assert_array_equal(np.concatenate(got),
                                          np.concatenate(want))


@pytest.mark.parametrize("bad", [0, 25, 39])
def test_split_protocol_error_after_valid_prefix(tmp_path, QS, bad):
    """A bad base: every record before it is served, in order, then the
    single stream's error text raises on every rank."""
    rng = np.random.default_rng(7)
    fa = tmp_path / "q.fna"
    seqs = _rand_seqs(rng, 40, 20)
    seqs[bad] = seqs[bad][:10] + "X" + seqs[bad][11:]
    _write_fasta(fa, seqs)
    want, want_err = _single(fa, 8)
    got, err = _split(QS, fa, 8)
    assert want_err is not None and str(err) == str(want_err)
    assert sum(len(c) for c in got) == bad
    if bad:
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.concatenate(want))


def test_split_protocol_nonuniform_and_single_rank(tmp_path, QS):
    fa = tmp_path / "q.fna"
    fa.write_text(">a\nACGT\n>b\nACGTAA\n")
    res, errs = run_ranks(2, lambda comm: QS.split_encoded_batches(
        fa, 4, comm=comm))
    assert res == [None, None] and errs == [None, None]
    res, _ = run_ranks(1, lambda comm: QS.split_encoded_batches(
        fa, 4, comm=comm))
    assert res == [None]
    assert QS.split_encoded_batches(fa, 4) is None  # no process group


def test_split_protocol_empty_stream_raises(tmp_path, QS, monkeypatch):
    from smafa_tpu_torch.io.fastx import FastxError

    fa = tmp_path / "q.fna"
    fa.write_text(">a\nACGT\n")
    monkeypatch.setattr(QS, "_parse_slice", lambda *_a: QS._empty())
    _res, errs = run_ranks(2, lambda comm: QS.split_encoded_batches(
        fa, 4, comm=comm))
    assert all(isinstance(e, FastxError) and "Empty" in str(e) for e in errs)
