"""query op: scan a query FASTX stream against a db.

Port of ``smafa_tpu.engine.query`` in both of its modes, with the same
pinned semantics:

- best-hit (no ``--max-num-hits``, or ``--max-num-hits 1``; reference
  lib.rs:224): every window at the minimum distance prints, in
  subject-index order (lib.rs:306-313), unless the minimum exceeds
  ``--max-divergence``;
- K-mode (``--max-num-hits K``, K > 1): every window at distance <=
  min(K-th smallest distance, ``--max-divergence``) prints, in
  (distance, index) order, cutoff ties included (lib.rs:241-295);
  ``--limit-per-sequence`` caps consecutive runs of one decoded
  sequence (lib.rs:269-289);
- output line ``{query_number}\\t{subject_idx}\\t{distance}\\t{decoded}``
  with query_number counting records from 0 (lib.rs:231, 310).

One batch is in flight: the first pass of batch k+1 (best-hit phase A,
or the K-mode cutoff passes) is launched before batch k is resolved and
emitted, on a stream of its own on a GPU (``ScanRunner._ahead``), so
batch k's compaction and read-back do not wait for it and the device
scans while the host parses and formats.
``--resume-state`` is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import io
import logging
import os
import sys
import time
from pathlib import Path
from typing import TextIO

import numpy as np
import torch

from smafa_tpu_torch.core import alphabet
from smafa_tpu_torch.io.db import load_db
from smafa_tpu_torch.io.fastx import read_encoded_batches
from smafa_tpu_torch.utils.profiling import StageTimers

logger = logging.getLogger("smafa")

DEFAULT_BATCH = 2048


class QueryError(ValueError):
    pass


class NotPortedError(QueryError):
    def __init__(self, what: str):
        super().__init__(f"{what} is not ported to smafa_tpu_torch yet "
                         "(see ROADMAP.md); use smafa_tpu for it")


class _DbOnDevice:
    """A loaded db, resident on one device as codes and embedded twin."""

    def __init__(self, windows, device: torch.device):
        from smafa_tpu_torch.parallel.runner import ScanRunner

        self.windows = windows
        self.n_windows = len(windows)
        self.seq_len = windows.length
        self.runner = ScanRunner.from_codes(windows.codes, self.seq_len or 1,
                                            device)
        self._decoded: dict[int, str] = {}

    def decoded(self, idx: int) -> str:
        s = self._decoded.get(idx)
        if s is None:
            s = self.windows.get_as_string(idx)
            self._decoded[idx] = s
        return s


def _auto_batch(db: _DbOnDevice) -> int:
    """Bigger query batches for bigger dbs, so per-batch device work
    outweighs the per-batch host round trip. These tiers were tuned on a
    TPU (smafa_tpu.engine.query._auto_batch) and are kept as they are
    until they are measured again on the GPU (ROADMAP.md)."""
    n_windows = db.n_windows
    if n_windows >= 1 << 22:
        return 65536
    if n_windows >= 1 << 20:
        return 32768
    if n_windows >= 1 << 19:
        return 16384
    if n_windows >= 1 << 16:
        return 4096
    return DEFAULT_BATCH


def query(
    db_path: str | Path,
    query_fasta: str | Path,
    device: torch.device,
    max_divergence: int | None = None,
    max_num_hits: int | None = None,
    limit_per_sequence: int | None = None,
    out: TextIO | None = None,
    batch_size: int | None = None,
) -> StageTimers:
    """Scan query_fasta against db_path on ``device``, emitting
    reference-format TSV. Returns the stage timers of the run."""
    out = out or sys.stdout
    logger.info("Decoding db file %s", db_path)
    t0 = time.time()
    windows = load_db(db_path)
    # 1 is a special case, equivalent to None (reference lib.rs:224).
    k_mode = max_num_hits if (max_num_hits is not None and max_num_hits != 1) else None
    if k_mode is not None and k_mode < 1:
        raise QueryError("max-num-hits must be >= 1")
    if k_mode is None and limit_per_sequence is not None:
        # Reference panics with this exact text (lib.rs:301-303).
        raise QueryError(
            "limit_per_sequence is implemented unless max_num_hits > 1. "
            "It can be implemented by analogy, just haven't gotten around to it."
        )
    db = _DbOnDevice(windows, device)
    if batch_size is None:
        batch_size = _auto_batch(db)

    logger.info("Querying ..")
    timers = StageTimers()
    if not Path(query_fasta).exists():
        # Reference panic text on open failure (lib.rs:221).
        raise QueryError(f"valid path/file of query fasta: {query_fasta}")
    pending: tuple | None = None  # (qnum0, nq, codes, handle)
    query_number = 0
    batches = read_encoded_batches(query_fasta, batch_size=batch_size)
    while True:
        # Parsing, validating, or launching the next batch can raise
        # (invalid base, length mismatch). The already-scanned pending
        # batch is emitted FIRST, matching the reference's streaming
        # behavior: it prints every record's hits up to the offending
        # one before panicking (lib.rs:231-318).
        try:
            with timers.stage("parse"):
                item = next(batches, None)
            if item is not None:
                _ids, _raws, codes = item
                nq_batch = codes.shape[0]
                qlen = codes.shape[1] if codes.ndim == 2 else 0
                windows.check_query_length(qlen)
                if db.n_windows == 0:
                    raise QueryError("Cannot query an empty database")
                with timers.stage("dispatch"):
                    handle = (db.runner.min_count_async(codes)
                              if k_mode is None else
                              db.runner.kmode_stats_async(codes, k_mode,
                                                          max_divergence))
                timers.count("comparisons", nq_batch * db.n_windows)
                current = (query_number, nq_batch, codes, handle)
                query_number += nq_batch
            else:
                current = None
        except Exception:
            if pending is not None:
                _drain_batch(out, db, pending, k_mode, max_divergence,
                             limit_per_sequence, timers)
            raise
        if pending is not None:
            _drain_batch(out, db, pending, k_mode, max_divergence,
                         limit_per_sequence, timers)
        pending = current
        if current is None:
            break
    timers.log_report(logging.DEBUG)
    logger.info("Querying complete, took %d seconds", int(time.time() - t0))
    return timers


def _drain_batch(out, db, pending, k_mode, max_divergence,
                 limit_per_sequence, timers):
    """Resolve one launched batch and emit its hits."""
    qnum0, nq, p_codes, p_handle = pending
    if k_mode is not None:
        with timers.stage("scan"):
            counts, rows, idx, dv = db.runner.kmode_flat(
                p_codes, k_mode, max_divergence, stats_handle=p_handle)
        with timers.stage("emit"):
            if limit_per_sequence is None:
                if rows.size:
                    _emit_bulk(out, qnum0 + rows.astype(np.int64), idx, dv, db)
            else:
                starts = np.cumsum(counts.astype(np.int64)) - counts
                for row in range(nq):
                    s, n = int(starts[row]), int(counts[row])
                    _emit_kmode_row(out, qnum0 + row, dv[s:s + n],
                                    idx[s:s + n], db, limit_per_sequence)
        return
    with timers.stage("scan"):
        dist, _counts, rows, idx = db.runner.best_hit(
            p_codes, max_divergence, handle=p_handle)
    with timers.stage("emit"):
        if rows.size:
            _emit_bulk(out, qnum0 + rows.astype(np.int64), idx, dist[rows], db)


def _write_bytes(out, data: bytes) -> None:
    """Write pre-formatted ASCII bytes to a text stream, straight to its
    binary buffer when that is safe (an exact TextIOWrapper in an ASCII
    compatible encoding without newline translation); the text layer is
    flushed first so earlier str writes keep their order. OSError
    propagates: a retry after a partial binary write would duplicate
    output."""
    if (type(out) is io.TextIOWrapper
            and (out.encoding or "").lower().replace("-", "")
            in ("utf8", "ascii", "usascii")
            and os.linesep == "\n"):
        try:
            binary = out.buffer
        except (AttributeError, io.UnsupportedOperation):
            binary = None
        if binary is not None:
            out.flush()
            binary.write(data)
            return
    out.write(data.decode("ascii"))


def _emit_bulk(out, qnums, subj, d, db):
    L = db.seq_len
    blob = alphabet.DECODE_BYTES[db.windows.codes[subj]]
    flat = blob.tobytes().decode("ascii")
    text = "".join(
        f"{q}\t{s}\t{dd}\t{flat[k * L:(k + 1) * L]}\n"
        for k, (q, s, dd) in enumerate(zip(qnums.tolist(), subj.tolist(), d.tolist()))
    )
    _write_bytes(out, text.encode("ascii"))


def _emit_kmode_row(out, qnum, dists, idxs, db, limit_per_sequence):
    """Emit one row's sorted K-mode hit list under the reference's
    limit-per-sequence rule: a run of consecutive hits with one decoded
    sequence prints at most ``limit_per_sequence`` lines, and the run
    resets when another sequence comes between (lib.rs:269-289)."""
    last_seq: tuple[str, int] | None = None
    lines = []
    for i, d in zip(idxs.tolist(), dists.tolist()):
        s = db.decoded(i)
        if last_seq is not None and last_seq[0] == s:
            if last_seq[1] >= limit_per_sequence:
                continue
            last_seq = (s, last_seq[1] + 1)
        else:
            last_seq = (s, 1)
        lines.append(f"{qnum}\t{i}\t{d}\t{s}\n")
    out.write("".join(lines))
