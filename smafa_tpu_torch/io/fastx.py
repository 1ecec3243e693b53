"""Streaming FASTA/FASTQ reader with transparent gzip — the pure-Python
parse path of ``smafa_tpu.io.fastx`` (reference lib.rs:143-144, 221;
gz support pinned by reference tests/test_cmdline.rs:194-201).

Records are yielded as ``(id, seq)`` where ``id`` is the full header after
the ``>``/``@`` marker and ``seq`` is the raw sequence bytes. FASTA
sequences may wrap over multiple lines; FASTQ records are the standard
4-line form. The native C++ ingest of ``smafa_tpu.native`` is not ported
yet (ROADMAP.md queue 1); these parsers give the same records and errors.
"""

from __future__ import annotations

import gzip
import io
from pathlib import Path
from typing import Iterator

import numpy as np

from smafa_tpu_torch.core.alphabet import encode_bytes

_GZIP_MAGIC = b"\x1f\x8b"


class FastxError(ValueError):
    pass


def open_maybe_gzip(path: str | Path) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == _GZIP_MAGIC:
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=1 << 20)
    return io.BufferedReader(f, buffer_size=1 << 20) if not isinstance(f, io.BufferedReader) else f


def read_records(path: str | Path) -> Iterator[tuple[str, bytes]]:
    """Yield (id, seq_bytes) for each record in a FASTA/FASTQ(.gz) file."""
    with open_maybe_gzip(path) as f:
        first = f.peek(1)[:1]
        if not first:
            raise FastxError(f"Empty or invalid FASTX file: {path}")
        if first == b">":
            yield from _read_fasta(f)
        elif first == b"@":
            yield from _read_fastq(f)
        else:
            raise FastxError(f"Not a FASTA or FASTQ file (bad leading byte): {path}")


def _read_fasta(f) -> Iterator[tuple[str, bytes]]:
    header: str | None = None
    chunks: list[bytes] = []
    for line in f:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if header is not None:
                yield header, b"".join(chunks)
            header = line[1:].decode("utf-8", "replace")
            chunks = []
        elif line:
            if header is None:
                raise FastxError("Sequence data before first FASTA header")
            chunks.append(line)
    if header is not None:
        yield header, b"".join(chunks)


def _read_fastq(f) -> Iterator[tuple[str, bytes]]:
    while True:
        h = f.readline()
        if not h:
            return
        h = h.rstrip(b"\r\n")
        if not h:
            continue
        if not h.startswith(b"@"):
            raise FastxError("Malformed FASTQ record header")
        seq = f.readline().rstrip(b"\r\n")
        plus = f.readline()
        qual = f.readline()
        if not plus.startswith(b"+") or not qual:
            raise FastxError("Malformed FASTQ record")
        yield h[1:].decode("utf-8", "replace"), seq


def read_encoded_batches(
    path: str | Path,
    batch_size: int,
    expected_length: int | None = None,
    skip_records: int = 0,
) -> Iterator[tuple[list[str], list[bytes], np.ndarray]]:
    """Yield (ids, raw_seqs, codes[B, L]) batches of encoded records.

    Length uniformity inside a batch follows from the db contract; a
    mismatching record starts a new batch, so the caller's WindowSet
    length check raises with the reference text (lib.rs:71-78).
    ``skip_records`` skips a prefix of the stream.
    """
    ids: list[str] = []
    raws: list[bytes] = []
    rows: list[np.ndarray] = []
    length = expected_length
    records = read_records(path)
    for _ in range(skip_records):
        if next(records, None) is None:
            return
    for rid, seq in records:
        try:
            chans = encode_bytes(seq, identifier=rid)
        except Exception:
            # Streaming parity: emit the accumulated records before the
            # offending one, then raise (reference lib.rs:231-238).
            if ids:
                yield ids, raws, np.vstack(rows)
            raise
        if length is None:
            length = len(seq)
        if len(seq) != length or len(ids) == batch_size:
            if ids:
                yield ids, raws, np.vstack(rows) if rows else np.empty((0, length or 0), np.uint8)
            ids, raws, rows = [], [], []
            length = len(seq) if expected_length is None else expected_length
        ids.append(rid)
        raws.append(seq)
        rows.append(chans)
    if ids:
        yield ids, raws, np.vstack(rows)
