"""The port's chunked native ingest (smafa_tpu_torch.io.fastx
._chunked_native_batches), mirroring tests/test_chunked_ingest.py:
batches and records equal to the pure-Python parser's under
SMAFA_TPU_NO_NATIVE=1 at any window size, and to smafa_tpu's; peak
memory O(window), not O(file).

The bounded-memory child reads its own high-water mark (VmHWM, which a
new program starts afresh) rather than ru_maxrss, which a child inherits
from the pytest worker that starts it, and it imports no torch.
"""

from __future__ import annotations

import gzip
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from smafa_tpu.io import fastx as fastx0
from smafa_tpu_torch.io import fastx

ALPHA = np.array(list("ACGTN"))


def _write_fasta(path, n, L, seed=0, wrap=None, crlf=False):
    rng = np.random.default_rng(seed)
    eol = "\r\n" if crlf else "\n"
    with open(path, "w", newline="") as f:
        for i in range(n):
            s = "".join(ALPHA[rng.integers(0, 4, L)])
            if wrap:
                s = eol.join(s[j:j + wrap] for j in range(0, len(s), wrap))
            f.write(f">rec{i} extra meta{eol}{s}{eol}")


def _write_fastq(path, n, L, seed=0, blanks=False, gz=False):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        s = "".join(ALPHA[rng.integers(0, 4, L)])
        # quality lines deliberately start with '@' sometimes — the
        # reason FASTQ cannot split on a '\n@' scan
        q = ("@" if i % 3 == 0 else "I") + "I" * (L - 1)
        lines.append(f"@r{i}\n{s}\n+\n{q}\n")
        if blanks and i % 5 == 0:
            lines.append("\n")
    data = "".join(lines).encode()
    if gz:
        path.write_bytes(gzip.compress(data))
    else:
        path.write_bytes(data)


def _python_batches(path, batch_size, monkeypatch, skip=0):
    monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    out, err = [], None
    try:
        for b in fastx.read_encoded_batches(path, batch_size=batch_size,
                                            skip_records=skip):
            out.append(b)
    except Exception as e:  # noqa: BLE001
        err = e
    monkeypatch.delenv("SMAFA_TPU_NO_NATIVE")
    return out, err


def _native_batches(path, batch_size, chunk, monkeypatch, skip=0):
    monkeypatch.setenv("SMAFA_TPU_INGEST_CHUNK", str(chunk))
    out, err = [], None
    try:
        for b in fastx.read_encoded_batches(path, batch_size=batch_size,
                                            skip_records=skip):
            out.append(b)
    except Exception as e:  # noqa: BLE001
        err = e
    return out, err


def _flatten(batches):
    ids = [i for b in batches for i in b[0]]
    raws = [r for b in batches for r in b[1]]
    codes = (np.concatenate([b[2] for b in batches])
             if batches else np.empty((0, 0), np.uint8))
    return ids, raws, codes


@pytest.mark.parametrize("chunk", [97, 256, 4096, 1 << 26])
def test_chunked_fasta_matches_python(tmp_path, monkeypatch, chunk):
    fa = tmp_path / "a.fna"
    _write_fasta(fa, 157, 33)
    want, werr = _python_batches(fa, 16, monkeypatch)
    got, gerr = _native_batches(fa, 16, chunk, monkeypatch)
    assert werr is None and gerr is None
    wi, wr, wc = _flatten(want)
    gi, gr, gc = _flatten(got)
    assert gi == wi and gr == wr
    np.testing.assert_array_equal(gc, wc)
    ri, rr, rc = _flatten(list(fastx0.read_encoded_batches(fa, batch_size=16)))
    assert ri == gi and rr == gr
    np.testing.assert_array_equal(rc, gc)
    # full batches except the tail, regardless of window boundaries
    assert [b[2].shape[0] for b in got][:-1] == [16] * (len(got) - 1)


def test_chunked_multiline_crlf_fasta(tmp_path, monkeypatch):
    fa = tmp_path / "w.fna"
    _write_fasta(fa, 63, 120, wrap=37, crlf=True)
    want, _ = _python_batches(fa, 8, monkeypatch)
    got, gerr = _native_batches(fa, 8, 199, monkeypatch)
    assert gerr is None
    assert _flatten(got)[0] == _flatten(want)[0]
    np.testing.assert_array_equal(_flatten(got)[2], _flatten(want)[2])


@pytest.mark.parametrize("blanks", [False, True])
@pytest.mark.parametrize("gz", [False, True])
def test_chunked_fastq_matches_python(tmp_path, monkeypatch, blanks, gz):
    fq = tmp_path / ("a.fq.gz" if gz else "a.fq")
    _write_fastq(fq, 120, 29, blanks=blanks, gz=gz)
    want, _ = _python_batches(fq, 13, monkeypatch)
    got, gerr = _native_batches(fq, 13, 211, monkeypatch)
    assert gerr is None
    wi, wr, wc = _flatten(want)
    gi, gr, gc = _flatten(got)
    assert gi == wi and gr == wr
    np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("skip", [0, 7, 100, 156, 157])
def test_chunked_resume_skip(tmp_path, monkeypatch, skip):
    fa = tmp_path / "a.fna"
    _write_fasta(fa, 157, 21)
    want, _ = _python_batches(fa, 16, monkeypatch, skip=skip)
    got, gerr = _native_batches(fa, 16, 300, monkeypatch, skip=skip)
    assert gerr is None
    assert _flatten(got)[0] == _flatten(want)[0]
    np.testing.assert_array_equal(_flatten(got)[2], _flatten(want)[2])


def test_chunked_deferred_error_across_windows(tmp_path, monkeypatch):
    """Invalid base deep in the stream: every earlier record's batch is
    served first, then the exact error raises (lib.rs:231-318)."""
    fa = tmp_path / "bad.fna"
    rng = np.random.default_rng(9)
    with open(fa, "w") as f:
        for i in range(90):
            s = "".join(ALPHA[rng.integers(0, 4, 25)])
            if i == 61:
                s = s[:10] + "X" + s[11:]
            f.write(f">s{i}\n{s}\n")
    want, werr = _python_batches(fa, 8, monkeypatch)
    got, gerr = _native_batches(fa, 8, 128, monkeypatch)
    assert werr is not None and gerr is not None
    assert str(werr) == str(gerr)
    assert _flatten(got)[0] == _flatten(want)[0]
    np.testing.assert_array_equal(_flatten(got)[2], _flatten(want)[2])


def test_chunked_record_larger_than_window(tmp_path, monkeypatch):
    """A record bigger than the window grows the window until a
    boundary fits."""
    fa = tmp_path / "big.fna"
    _write_fasta(fa, 5, 4000)
    want, _ = _python_batches(fa, 2, monkeypatch)
    got, gerr = _native_batches(fa, 2, 64, monkeypatch)
    assert gerr is None
    assert _flatten(got)[0] == _flatten(want)[0]
    np.testing.assert_array_equal(_flatten(got)[2], _flatten(want)[2])


def test_chunked_nonuniform_lengths(tmp_path, monkeypatch):
    fa = tmp_path / "mix.fna"
    fa.write_text("".join(
        f">s{i}\n{'AC' * (5 if (i // 7) % 2 == 0 else 7)}\n"
        for i in range(40)
    ))
    want, _ = _python_batches(fa, 6, monkeypatch)
    got, gerr = _native_batches(fa, 6, 64, monkeypatch)
    assert gerr is None
    # record order + per-record sequences identical; every batch uniform
    assert [i for b in got for i in b[0]] == [i for b in want for i in b[0]]
    assert [r for b in got for r in b[1]] == [r for b in want for r in b[1]]
    for b in got:
        assert b[2].ndim == 2 and len({len(r) for r in b[1]}) == 1


def test_chunked_expected_length_mixed_widths(tmp_path, monkeypatch):
    """Regression (round-5 review): with expected_length set, a run at
    the expected width arriving AFTER a divergent run must not
    concatenate mixed-width blocks."""
    fa = tmp_path / "mix.fna"
    fa.write_text(">a\nACGT\n>b\nACGT\n>c\nACGTAA\n>d\nACGT\n")
    monkeypatch.setenv("SMAFA_TPU_INGEST_CHUNK", str(1 << 20))
    got = list(fastx.read_encoded_batches(fa, batch_size=10,
                                          expected_length=4))
    assert [i for b in got for i in b[0]] == ["a", "b", "c", "d"]
    for b in got:
        assert len({c.shape[0] for c in [b[2]]}) == 1 and b[2].ndim == 2
        assert len({len(r) for r in b[1]}) == 1  # per-batch uniform


def test_chunked_fastq_blank_seq_and_qual_lines(tmp_path, monkeypatch):
    """Regression (round-5 review): the native parser accepts records
    whose sequence/quality lines are BLANK (positional 4-line form);
    the window cutter must not misalign on them at any window size."""
    fq = tmp_path / "b.fq"
    fq.write_text(
        "@r0\nACGT\n+\nIIII\n"
        "@r1\nACGT\n+\n@III\n"
        "@r2\n\n+\n\n"            # blank sequence AND quality
        "@r3\nACGT\n+\nIIII\n"
        "@r4\nACGT\n+\nIIII\n"
    )
    want, werr = _python_batches(fq, 3, monkeypatch)
    for chunk in range(8, 80, 7):
        got, gerr = _native_batches(fq, 3, chunk, monkeypatch)
        assert (gerr is None) == (werr is None), (chunk, gerr, werr)
        assert [i for b in got for i in b[0]] == \
            [i for b in want for i in b[0]], chunk
        assert [r for b in got for r in b[1]] == \
            [r for b in want for r in b[1]], chunk


def test_chunked_read_records_and_count(tmp_path, monkeypatch, capsys):
    fq = tmp_path / "c.fq"
    _write_fastq(fq, 57, 19)
    monkeypatch.setenv("SMAFA_TPU_INGEST_CHUNK", "173")
    native = list(fastx.read_records(fq))
    monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    python = list(fastx.read_records(fq))
    assert native == python
    monkeypatch.delenv("SMAFA_TPU_NO_NATIVE")
    from smafa_tpu_torch.cli import main

    assert main(["count", "-i", str(fq)]) == 0
    out = capsys.readouterr().out
    assert '"num_reads":57' in out and f'"num_bases":{57 * 19}' in out


def test_chunked_bounded_memory(tmp_path):
    """Peak RSS with small windows must be far below the whole-file
    parse — the reference's memory envelope (lib.rs:143-148)."""
    fa = tmp_path / "big.fna"
    rng = np.random.default_rng(0)
    with open(fa, "wb") as f:
        block = []
        for i in range(120_000):
            s = ALPHA[rng.integers(0, 4, 300)]
            block.append(b">r%d\n%s\n" % (i, "".join(s).encode()))
            if len(block) == 10_000:
                f.write(b"".join(block))
                block = []
        f.write(b"".join(block))
    size = fa.stat().st_size
    assert size > 30 << 20
    script = (
        "import sys\n"
        "from smafa_tpu_torch.io import fastx\n"
        "n = 0\n"
        "for ids, raws, codes in fastx.read_encoded_batches("
        "sys.argv[1], batch_size=4096):\n"
        "    n += codes.shape[0]\n"
        "assert n == 120_000, n\n"
        "assert 'torch' not in sys.modules\n"
        "status = open('/proc/self/status').read().split('VmHWM:')[1]\n"
        "print(int(status.split()[0]))\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent

    def rss(chunk):
        env = {"SMAFA_TPU_INGEST_CHUNK": str(chunk), "PATH": "/usr/bin:/bin"}
        out = subprocess.run(
            [sys.executable, "-c", script, str(fa)], env=env,
            capture_output=True, text=True, cwd=root, check=True,
        )
        return int(out.stdout.strip()) * 1024  # VmHWM is in kB

    small = rss(2 << 20)
    big = rss(1 << 30)
    # whole-file parse holds raw + seqs + codes + ids concurrently;
    # chunked holds O(window + batch)
    assert small < big - size // 2, (small, big, size)
