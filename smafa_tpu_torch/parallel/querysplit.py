"""Multi-process query-stream split: each process parses its own byte range.

Counterpart of ``smafa_tpu.parallel.querysplit``, over ``parallel.comm``
in place of ``jax.experimental.multihost_utils``. Without it every
process of a multi-process run parses and encodes the whole query
stream; with it each parses about 1/P of the file:

1. Every process cuts the file into P byte ranges the same way, each
   boundary moved forward to the next record start: ``\\n>`` in plain
   FASTA, a validated ``\\n@`` in plain FASTQ (a quality line may start
   with '@', so the line two physical lines later must be the '+'
   separator). Gzip is not byte-addressable and keeps the replicated
   parse, as do query files of more than one read length.
2. Each process parses and encodes its range (natively where the library
   is built). One exchange of metadata (record count, read length,
   deferred error text) gives every process the same batch schedule and
   the global record numbering.
3. The batch loop walks the ranges in file order; each batch is one
   broadcast from the range's owner.
4. A deferred parse or encode error surfaces where the serial reader
   would raise it, after every batch of earlier ranges and of the
   erring range's valid prefix, with the owner's exact text on every
   process. A parse that fails outright (a malformed FASTQ record) is
   deferred the same way, with no valid prefix, so no peer is left
   waiting for the failed one.

``skip_records`` (``--resume-state``) maps through the same prefix sums.
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np
import torch

from smafa_tpu_torch.io.fastx import FastxError, _read_fasta, _read_fastq

_ERR_TEXT_CAP = 2048
_SCAN_WINDOW = 1 << 20


def split_format(path: str | Path) -> bytes | None:
    """b'>' for plain FASTA, b'@' for plain FASTQ, None otherwise (gzip
    and unreadable files keep the replicated parse)."""
    try:
        with open(path, "rb") as f:
            first = f.read(1)
    except OSError:
        return None
    return first if first in (b">", b"@") else None


def _validated_fastq_start(buf: bytes, base: int) -> int | None:
    """Offset in ``buf`` of the first true FASTQ record start at or after
    ``base``, or None: a ``\\n@`` line whose line two physical lines later
    starts with '+' (a quality line posing as a header fails this)."""
    pos = base
    while True:
        hit = buf.find(b"\n@", pos)
        if hit < 0:
            return None
        cand = hit + 1
        p = cand
        for _ in range(2):
            nl = buf.find(b"\n", p)
            if nl < 0:
                return None  # the structure runs off the window: widen
            p = nl + 1
        if p >= len(buf):
            return None
        if buf[p:p + 1] == b"+":
            return cand
        pos = hit + 1


def byte_ranges(path: str | Path, n_ranges: int,
                fmt: bytes = b">") -> list[int]:
    """n_ranges + 1 boundaries into the file, each but 0 and the end at a
    record start. Deterministic, so every process computes the same cut
    without communication."""
    size = Path(path).stat().st_size
    bounds = [0]
    with open(path, "rb") as f:
        for p in range(1, n_ranges):
            cut = p * size // n_ranges
            if cut <= bounds[-1]:
                bounds.append(bounds[-1])
                continue
            pos = max(cut - 1, 0)
            boundary = size
            win = b""
            while True:
                f.seek(pos + len(win))
                more = f.read(_SCAN_WINDOW)
                win = win + more
                if fmt == b">":
                    hit = win.find(b"\n>")
                    rec = hit + 1 if hit >= 0 else None
                else:
                    rec = _validated_fastq_start(win, 0)
                if rec is not None:
                    boundary = pos + rec
                    break
                if not more:
                    break  # the end of the file, no record start after cut
            bounds.append(max(boundary, bounds[-1]))
    bounds.append(size)
    return bounds


class _RangeParse:
    """One process's range, parsed and encoded: its valid records, and the
    deferred error's exact text if the range has one."""

    def __init__(self, n_ok: int, length: int, codes: np.ndarray,
                 error_text: str | None):
        self.n_ok = n_ok
        self.length = length  # -1: more than one length in the range
        self.codes = codes    # uint8 [n_ok, length] (empty if nonuniform)
        self.error_text = error_text


def _empty(err: str | None = None) -> _RangeParse:
    return _RangeParse(0, 0, np.empty((0, 0), np.uint8), err)


def _parse_slice(path: str | Path, start: int, end: int) -> _RangeParse:
    if end <= start:
        return _empty()
    with open(path, "rb") as f:
        f.seek(start)
        buf = f.read(end - start)

    from smafa_tpu_torch.native import ingest

    try:
        parsed = ingest.parse_buffer(buf, encode=True, path=str(path))
    except FastxError as e:
        return _empty(str(e))
    if parsed is not None:
        if parsed.n == 0:
            return _empty()
        n_ok = parsed.n if parsed.error is None else parsed.error_record
        err = str(parsed.error) if parsed.error is not None else None
        lengths = parsed.seq_lengths()[:n_ok]
        if n_ok == 0:
            return _empty(err)
        if int(lengths.min()) != int(lengths.max()):
            return _RangeParse(n_ok, -1, np.empty((0, 0), np.uint8), err)
        L = int(lengths[0])
        codes = parsed.codes[: parsed.seq_offs[n_ok]].reshape(n_ok, L)
        return _RangeParse(n_ok, L, np.ascontiguousarray(codes), err)

    # pure Python (SMAFA_TPU_NO_NATIVE=1): the format's streaming reader
    from smafa_tpu_torch.core.alphabet import encode_bytes

    reader = _read_fastq if buf[:1] == b"@" else _read_fasta
    rows: list[np.ndarray] = []
    err = None
    length: int | None = None
    uniform = True
    try:
        for rid, seq in reader(_io.BytesIO(buf)):
            rows.append(encode_bytes(seq, identifier=rid))
            if length is None:
                length = len(seq)
            elif len(seq) != length:
                uniform = False
    except Exception as e:  # deferred: the valid prefix still serves
        err = str(e)
    n_ok = len(rows)
    if n_ok == 0:
        return _empty(err)
    if not uniform:
        return _RangeParse(n_ok, -1, np.empty((0, 0), np.uint8), err)
    return _RangeParse(n_ok, int(length), np.vstack(rows), err)


def _pack_meta(rp: _RangeParse) -> np.ndarray:
    meta = np.zeros(3 + _ERR_TEXT_CAP, np.int64)
    meta[0] = rp.n_ok
    meta[1] = rp.length
    meta[2] = 1 if rp.error_text is not None else 0
    if rp.error_text is not None:
        raw = rp.error_text.encode("utf-8")[:_ERR_TEXT_CAP]
        meta[3:3 + len(raw)] = np.frombuffer(raw, np.uint8)
    return meta


def _unpack_err(meta_row: np.ndarray) -> str:
    raw = meta_row[3:][meta_row[3:] > 0].astype(np.uint8).tobytes()
    return raw.decode("utf-8", "replace")


def split_encoded_batches(path: str | Path, batch_size: int,
                          skip_records: int = 0, comm=None):
    """SPMD generator of (None, None, codes) batches in global record
    order, or None when the stream does not split (one process, gzip,
    more than one read length). Every process drives the generator in
    lockstep: the metadata exchange and each batch are collectives of
    ``comm`` (default: ``multihost.comm()``). The caller checks each
    batch's read length against the db, so that error keeps its text."""
    if comm is None:
        from smafa_tpu_torch.parallel import multihost

        comm = multihost.comm()
    fmt = split_format(path)
    if comm is None or comm.size <= 1 or fmt is None:
        return None
    P, pid = comm.size, comm.rank
    bounds = byte_ranges(path, P, fmt)
    rp = _parse_slice(path, bounds[pid], bounds[pid + 1])
    metas = torch.stack(comm.all_gather(
        torch.from_numpy(_pack_meta(rp)))).numpy()
    counts = metas[:, 0].astype(np.int64)
    lengths = metas[:, 1].astype(np.int64)
    if int(counts.sum()) == 0:
        # with no valid record anywhere, the first range's deferred error
        # is what the serial reader raises (file order = rank order)
        for owner in range(P):
            if metas[owner, 2]:
                raise FastxError(_unpack_err(metas[owner]))
        raise FastxError(f"Empty or invalid FASTX file: {path}")
    ls = set(int(x) for x in lengths[counts > 0])
    if -1 in ls or len(ls) > 1:
        return None  # more than one read length: the replicated parse
    L = ls.pop()

    def gen():
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for owner in range(P):
            n_p, off = int(counts[owner]), int(offsets[owner])
            for s in range(max(skip_records - off, 0), n_p, batch_size):
                e = min(s + batch_size, n_p)
                rows = (torch.from_numpy(rp.codes[s:e]) if pid == owner
                        else torch.empty((e - s, L), dtype=torch.uint8))
                yield None, None, comm.broadcast(rows, owner).numpy()
            if metas[owner, 2]:
                # the owner's range hit a deferred error: the stream stops
                # here on every process, after every earlier record
                raise FastxError(_unpack_err(metas[owner]))

    return gen()
