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

Hit lines are formatted by the native library (``native.ingest``):
decoded from the db's channel codes inside the threaded C++ fill, else
from a decoded blob, else, under ``SMAFA_TPU_NO_NATIVE=1``, in Python;
the ``--limit-per-sequence`` rows stay in Python, as in ``smafa_tpu``.

``resume_state`` checkpoints the query stream after each emitted batch
(``_ResumeState``). With ``SMAFA_TPU_TRACE_DIR`` set the batch loop runs
under ``torch.profiler`` (``utils.profiling.maybe_trace``).

In a multi-process run (``parallel.multihost``) every process runs this
loop in lockstep over its row shard of the db (``parallel.sharded``):
each parses its own byte range of a plain FASTA or FASTQ query file and
receives every batch from the range's owner (``parallel.querysplit``;
``SMAFA_TPU_QUERYSPLIT=0`` parses the whole file on every process), and
process 0's checkpoint is the one every process resumes from.
"""

from __future__ import annotations

import io
import json
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
from smafa_tpu_torch.parallel import multihost
from smafa_tpu_torch.utils.profiling import StageTimers, maybe_trace

logger = logging.getLogger("smafa")

DEFAULT_BATCH = 2048

# Query embeddings' worth of device bytes a batch row may take
# (``select.fit_batch``): its codes, its embedding and the embedding's
# temporaries, two batches in flight.
ROW_EMBEDS = 8


class QueryError(ValueError):
    pass


class _DbOnDevice:
    """A loaded db and its runner, in the layout
    ``parallel.select.make_runner`` chooses (in a multi-process run, the
    rank's row shard of the db's codes, a memmap in the native format)."""

    def __init__(self, windows, device: torch.device):
        from smafa_tpu_torch.parallel.select import make_runner

        self.windows = windows
        self.n_windows = len(windows)
        self.seq_len = windows.length
        self.runner = make_runner(windows.codes, self.seq_len or 1, device)
        self._decoded: dict[int, str] = {}

    def decoded(self, idx: int) -> str:
        s = self._decoded.get(idx)
        if s is None:
            s = self.windows.get_as_string(idx)
            self._decoded[idx] = s
        return s


def _auto_batch(db: _DbOnDevice) -> int:
    """Bigger query batches for bigger dbs, so per-batch device work
    outweighs the per-batch host round trip; the stream layout goes
    biggest, since its streaming tier uploads the whole db every pass.
    These tiers were tuned on a TPU (smafa_tpu.engine.query._auto_batch)
    and are kept as they are until they are measured again on the GPU
    (ROADMAP.md)."""
    from smafa_tpu_torch.parallel.slab import SlabStreamRunner

    if isinstance(db.runner, SlabStreamRunner):
        return 65536
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


def _fit_batch(tier: int, db: _DbOnDevice, device: torch.device) -> int:
    """The tier's batch, cut where its rows would not fit the card
    (``select.fit_batch``): at 2^25 bp a row embeds to 134 MB, and a
    tier of 2048 rows would not fit. Where the tier fits, it stays."""
    from smafa_tpu_torch.parallel.select import fit_batch

    fit = fit_batch(db.seq_len or 1, device, ROW_EMBEDS)
    return tier if fit is None else min(tier, fit)


def query(
    db_path: str | Path,
    query_fasta: str | Path,
    device: torch.device,
    max_divergence: int | None = None,
    max_num_hits: int | None = None,
    limit_per_sequence: int | None = None,
    out: TextIO | None = None,
    batch_size: int | None = None,
    resume_state: str | Path | None = None,
) -> StageTimers:
    """Scan query_fasta against db_path on ``device``, emitting
    reference-format TSV. Returns the stage timers of the run.

    ``resume_state``: optional JSON checkpoint path. After each emitted
    batch the output is flushed, then the count of finished queries and
    the output's byte offset are recorded (atomic rename); a restart with
    the same state file skips the finished prefix. On a seekable output
    (a file appended with ``>>``, or a file object) the restart truncates
    a torn last batch first, so the output is exactly once; on a pipe it
    is at least once."""
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
        batch_size = _fit_batch(_auto_batch(db), db, device)

    logger.info("Querying ..")
    timers = StageTimers()
    if not Path(query_fasta).exists():
        # Reference panic text on open failure (lib.rs:221).
        raise QueryError(f"valid path/file of query fasta: {query_fasta}")
    state = _ResumeState(resume_state, query_fasta, config={
        "database": str(db_path),
        "max_divergence": max_divergence,
        # K=1 is None (lib.rs:224): the normalized mode, so equivalent
        # invocations resume each other.
        "max_num_hits": k_mode,
        "limit_per_sequence": limit_per_sequence,
    })
    state.sync_processes()
    state.restore_output(out)
    if state.done:
        logger.info("Resuming after %d completed queries", state.done)
    with maybe_trace(cuda=device.type == "cuda", rank=(
            multihost.rank() if multihost.world_size() > 1 else None)):
        _scan_stream(out, db, query_fasta, batch_size, state, k_mode,
                     max_divergence, limit_per_sequence, timers)
    timers.log_report(logging.DEBUG)
    logger.info("Querying complete, took %d seconds", int(time.time() - t0))
    return timers


def _scan_stream(out, db, query_fasta, batch_size, state, k_mode,
                 max_divergence, limit_per_sequence, timers):
    """Parse, launch, resolve and emit every batch of the query
    stream, one batch in flight."""
    windows = db.windows
    pending: tuple | None = None  # (qnum0, nq, codes, handle)
    query_number = state.done
    batches = None
    if (multihost.world_size() > 1
            and os.environ.get("SMAFA_TPU_QUERYSPLIT", "") != "0"):
        from smafa_tpu_torch.parallel import querysplit

        batches = querysplit.split_encoded_batches(
            query_fasta, batch_size, skip_records=state.done)
        if batches is not None:
            logger.info("Query stream split across %d processes",
                        multihost.world_size())
    if batches is None:
        batches = read_encoded_batches(query_fasta, batch_size=batch_size,
                                       skip_records=state.done)
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
                state.mark_done(pending[0] + pending[1], out)
            raise
        if pending is not None:
            _drain_batch(out, db, pending, k_mode, max_divergence,
                         limit_per_sequence, timers)
            state.mark_done(pending[0] + pending[1], out)
        pending = current
        if current is None:
            break


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
    """Format and write hit lines: decoded from the db's codes inside the
    native fill, else from a decoded blob natively, else in Python."""
    from smafa_tpu_torch.native.ingest import (format_hits_tsv,
                                               format_hits_tsv_codes)

    L = db.seq_len
    buf = format_hits_tsv_codes(qnums, subj, d, db.windows.codes, L)
    if buf is not None:
        _write_bytes(out, buf)
        return
    blob = alphabet.DECODE_BYTES[db.windows.codes[subj]]
    offs = np.arange(subj.size, dtype=np.int64) * L
    buf = format_hits_tsv(qnums, subj, d, blob.reshape(-1), offs, L)
    if buf is not None:
        _write_bytes(out, buf)
        return
    flat = blob.tobytes().decode("ascii")
    out.write("".join(
        f"{q}\t{s}\t{dd}\t{flat[k * L:(k + 1) * L]}\n"
        for k, (q, s, dd) in enumerate(zip(qnums.tolist(), subj.tolist(), d.tolist()))
    ))


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


class _ResumeState:
    """JSON query-stream checkpoint: {"query_fasta", "done", "out_pos",
    "config"}, ``smafa_tpu.engine.query._ResumeState``.

    The output is flushed BEFORE the state is renamed into place (a flush
    that fails propagates rather than record unwritten batches as done).
    A crash between flush and rename leaves ``done`` before the batch
    already written; on a seekable output ``restore_output`` truncates it
    back to the recorded offset on resume, so a restart is exactly once.
    A pipe gets at least once: the torn batch's lines repeat.

    Subclass hooks (cluster resume): ``PATH_KEY`` / ``PATH_NOUN`` name the
    identity field; ``_load_extra`` / ``_extra_payload`` carry more JSON
    fields.
    """

    PATH_KEY = "query_fasta"
    PATH_NOUN = "query file"

    def __init__(self, path: str | Path | None, stream_path,
                 config: dict | None = None):
        self.path = Path(path) if path else None
        self.done = 0
        self.out_pos: int | None = None
        self.write_enabled = True  # multi-process: process 0 alone persists
        self._config = config or {}
        self._had_checkpoint = self.path is not None and self.path.exists()
        if self._had_checkpoint:
            data = json.loads(self.path.read_text())
            if data.get(self.PATH_KEY) != str(stream_path):
                raise QueryError(
                    f"Resume state {self.path} is for {self.PATH_NOUN} "
                    f"{data.get(self.PATH_KEY)!r}, not {str(stream_path)!r}"
                )
            # A prefix run under one set of options and a suffix under
            # another is no valid output for either. (A state without
            # "config" predates its recording and is accepted.)
            saved = data.get("config")
            if saved is not None and saved != self._config:
                diffs = sorted(
                    k for k in set(saved) | set(self._config)
                    if saved.get(k) != self._config.get(k)
                )
                raise QueryError(
                    f"Resume state {self.path} was created with different "
                    f"options ({', '.join(diffs)}); rerun with the original "
                    "options or delete the state file"
                )
            self.done = int(data.get("done", 0))
            self.out_pos = data.get("out_pos")
            self._load_extra(data)
        self._stream_path = str(stream_path)

    def _load_extra(self, data: dict) -> None:
        pass

    def _extra_payload(self) -> dict:
        return {}

    def sync_processes(self) -> None:
        """Multi-process: every process must skip the same prefix, so
        process 0's checkpoint rules: its ``done`` is broadcast (the state
        file need not exist where the others run), and the others neither
        persist nor truncate."""
        comm = multihost.comm()
        if self.path is None or comm is None or comm.size <= 1:
            return
        self.done = int(comm.broadcast(
            torch.tensor([self.done], dtype=torch.int64), 0))
        if comm.rank != 0:
            self.write_enabled = False
            self.out_pos = None

    def restore_output(self, out) -> None:
        if self.path is None or not self.write_enabled:
            return
        if not self._had_checkpoint:
            # Fresh run: the stream may hold bytes this run did not write
            # (runs appended with '>>'), so its current END is the
            # baseline, persisted as a done=0 checkpoint before anything
            # is emitted: a crash in batch 0 then truncates back to it.
            pos = None
            try:
                pos = out.seek(0, 2)
            except (AttributeError, OSError, io.UnsupportedOperation):
                pass  # not seekable: at least once
            self.out_pos = pos
            self._persist(0, pos)
            return
        if self.out_pos is None:
            # The first run's output was not seekable, and what survived
            # of it may have been gathered into this file by other means:
            # truncating could destroy emitted queries. Leave it alone.
            return
        target = self.out_pos
        try:
            end = out.seek(0, 2)
            if end >= target:
                out.seek(target)
                out.truncate()
            # else: the output was reset (a shell '>'); seeking forward
            # would punch a sparse hole, so leave it alone.
        except (AttributeError, OSError, io.UnsupportedOperation):
            pass  # not seekable: at least once

    def mark_done(self, done: int, out) -> None:
        self.done = done
        if self.path is None or not self.write_enabled:
            return
        # flushes the text layer and the binary buffer _write_bytes wrote
        # to; must succeed before the batch counts as done
        out.flush()
        pos = None
        try:
            pos = out.tell()
        except (AttributeError, OSError, io.UnsupportedOperation):
            pass
        self._persist(done, pos)

    def _persist(self, done: int, pos: int | None) -> None:
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps({
            self.PATH_KEY: self._stream_path, "done": done, "out_pos": pos,
            "config": self._config,
            **self._extra_payload(),
        }))
        tmp.replace(self.path)
