"""Row-sharded db layout over the processes of a run: each rank holds its
own rows, and the ranks' results merge through collectives.

Counterpart of ``smafa_tpu.parallel.sharded.ScanRunner`` on a multi-host
mesh (its multi-host ``__init__`` places each process's row shard on its
devices). Rank r owns a contiguous range of whole 64-row tiles,
``[off_r, off_r + n_r)``, and scans it with the runner the port's
one-device rule builds for those rows (``select.one_device_runner``): a
``ScanRunner``, or the stream layout where the shard passes the key
budget or the card's memory. Only the shard's rows are read from the
host view (a memmap of the native format pages in nothing else); the
whole view stays in ``_codes_host`` for the host enumeration of giant
tie rows.

The ``HitModesMixin`` primitives merge the ranks' local results in
ascending offset, as ``parallel.slab`` folds its slabs, with a
collective in place of the loop over slabs:

- phase A: each rank's min2 result in the pair form (dist, i_lo, i_hi,
  count) of global indices, gathered and folded in rank order by
  ``distance.min2_pair_fold``. A shard's keys pack shard-locally, so
  this one path serves dbs whose global keys would overflow (where
  ``smafa_tpu`` switches to shard-local keys and pair merges);
- the K-mode cutoff passes: counts summed and maxima taken over ranks
  (``all_reduce``), between the passes, on the device; the histogram
  (``SMAFA_TPU_KMODE_HIST=1``) summed over ranks the same way;
- compactions: each rank's hits with its offset added, gathered with
  their lengths and sorted by (row, index), in K-mode by (row, distance,
  index).

Collectives on CUDA tensors run inside a batch's first pass, on its side
stream. Under NCCL they queue there and the host does not wait; under
gloo (two ranks sharing a card) the staging through host memory waits
for the pass, so that pass no longer overlaps the previous batch's
compaction.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.parallel import multihost
from smafa_tpu_torch.parallel.runner import DeviceRunner

logger = logging.getLogger("smafa")


def shard_rows(n_windows: int, size: int) -> int:
    """Rows of a full shard: whole 64-row tiles, as few as cover the db
    in ``size`` shards."""
    m = D.WP_MULTIPLE
    return -(-(-(-n_windows // m)) // size) * m


def shard_range(n_windows: int, rank: int, size: int) -> tuple[int, int]:
    """(off, n) of rank's rows: whole 64-row tiles, the same count on every
    rank but the last ones, which may hold fewer rows or none."""
    per = shard_rows(n_windows, size)
    off = min(rank * per, n_windows)
    return off, min(per, n_windows - off)


def merge_groups(comm, timed, groups, local, kmode: bool, seq_len: int,
                 off: int = 0):
    """Every rank's compaction results, per group: ``local`` holds this
    rank's (rows, idx[, dist], counts) per group (None: nothing on this
    rank), its indices ``off`` below the global ones. The hit columns are
    gathered with their lengths (``timed(fn, *args)`` runs each
    collective) and sorted by (group, row, index), in K-mode by (group,
    row * (L + 1) + dist, index), whatever order each rank's list is in;
    the counts are summed. Returns per group (rows, idx[, dist],
    counts), the columns int32."""
    if local is None:
        e = np.empty(0, np.int32)
        local = [(e,) * (2 + kmode) + (np.zeros(len(ids), np.int64),)
                 for ids, _ in groups]
    cols = [np.concatenate([np.full(len(p[0]), g)
                            for g, p in enumerate(local)])]
    cols += [np.concatenate([p[c] for p in local]).astype(np.int64)
             for c in range(len(local[0]) - 1)]
    cols[2] += off
    mine = torch.from_numpy(np.stack(cols, axis=1))
    hits = torch.cat(timed(comm.gather_var, mine)).numpy()
    key = hits[:, 1]
    if kmode:
        key = key * (seq_len + 1) + hits[:, 3]
    hits = hits[np.lexsort((hits[:, 2], key, hits[:, 0]))]
    counts = torch.from_numpy(np.concatenate(
        [np.asarray(p[-1], np.int64) for p in local]))
    counts = timed(comm.all_reduce, counts, "sum").numpy()
    counts = np.split(counts, np.cumsum([len(ids) for ids, _ in groups])[:-1])
    edges = np.cumsum([c.sum() for c in counts])[:-1]
    return [(*h[:, 1:].T.astype(np.int32), c)
            for h, c in zip(np.split(hits, edges), counts)]


class ShardedRunner(DeviceRunner):
    """Every hit mode of ``ScanRunner`` (identical results) over a db whose
    rows are sharded over the ranks of ``comm`` (default: the process
    group of ``multihost.initialize``)."""

    def __init__(self, codes: np.ndarray, seq_len: int, device: torch.device,
                 comm=None):
        from smafa_tpu_torch.parallel.select import one_device_runner

        super().__init__(device)
        self.comm = comm if comm is not None else multihost.comm()
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        if self.n_windows >= 2**31:
            raise ValueError("db indices must fit int32")
        self._codes_host = codes
        self.off, self.n_local = shard_range(self.n_windows, self.comm.rank,
                                             self.comm.size)
        self.local = (one_device_runner(codes[self.off:self.off + self.n_local],
                                        self.seq_len, self.device)
                      if self.n_local else None)
        # the mixin reads these only from packed keys; merged results come
        # in the pair form
        self.wp, self.shift = self.n_windows, None
        # Row groups of a compaction depend on the span one mask covers,
        # which must be the same on every rank: the widest local one.
        span = torch.tensor([self.local._compact_span_rows()
                             if self.local is not None else 0])
        self._span_rows = max(1, int(self.comm.all_reduce(span, "max")))
        self.merge_s = 0.0  # host seconds in the merges' collectives
        logger.info("sharded layout: rank %d of %d holds rows [%d, %d) in "
                    "the %s layout", self.comm.rank, self.comm.size, self.off,
                    self.off + self.n_local,
                    type(self.local).__name__ if self.local is not None
                    else "no")

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.merge_s += time.perf_counter() - t0

    # -- HitModesMixin primitives ------------------------------------------

    def _compact_span_rows(self) -> int:
        return self._span_rows

    def _local_pairs(self, q_emb: torch.Tensor) -> torch.Tensor:
        """This rank's phase A as int32 [4, B] (dist, i_lo, i_hi, count) of
        global indices; an empty shard's is the empty carry."""
        carry = D.min2_pair_init(q_emb.shape[0], q_emb.device)
        if self.local is not None:
            res = self.local._phase_a(q_emb)
            if len(res) == 3:  # global keys of a ScanRunner over the shard
                lo, hi, cnt = res
                carry = D.min2_pair_merge(carry, lo, hi, cnt, self.off,
                                          self.local.wp, self.local.shift,
                                          self.seq_len)
            else:  # the stream layout's pair form, shard-local indices
                (d, i_lo, i_hi), cnt = res
                found = d < 2**30
                carry = (d, torch.where(found, i_lo + self.off, i_lo),
                         torch.where(found, i_hi + self.off, i_hi), cnt)
        return torch.stack(carry)

    def _phase_a(self, q_emb: torch.Tensor):
        """Every rank's pair carry, folded in rank order: (pair [3, B],
        cnt)."""
        parts = self._timed(self.comm.all_gather, self._local_pairs(q_emb))
        acc = tuple(parts[0])
        for part in parts[1:]:
            acc = D.min2_pair_fold(acc, tuple(part))
        return D.min2_pair_finish(acc)

    def _kstats(self, q_emb: torch.Tensor, ts: torch.Tensor):
        """One K-mode cutoff pass: counts summed and maxima taken over
        the ranks' shards."""
        if self.local is not None:
            cnt, mx = self.local._kstats(q_emb, ts)
        else:
            cnt = torch.zeros(tuple(ts.shape), dtype=torch.int32,
                              device=q_emb.device)
            mx = torch.full((q_emb.shape[0],), -1, dtype=torch.int32,
                            device=q_emb.device)
        return (self._timed(self.comm.all_reduce, cnt, "sum"),
                self._timed(self.comm.all_reduce, mx, "max"))

    def _hist(self, q_emb: torch.Tensor) -> torch.Tensor:
        """The K-mode distance histogram: each rank's over its shard,
        summed over the ranks."""
        if self.local is not None:
            h = self.local._hist(q_emb)
        else:
            h = torch.zeros((q_emb.shape[0], self.seq_len + 1),
                            dtype=torch.int32, device=q_emb.device)
        return self._timed(self.comm.all_reduce, h, "sum")

    def _compact_groups(self, q_emb: torch.Tensor, groups):
        """Every best-hit compaction dispatch of a batch on every rank's
        shard: per group, (rows, idx) in (row, index) order and the per-row
        hit counts, as ``ScanRunner._compact`` returns them."""
        if not groups:
            return []
        local = (None if self.local is None
                 else self.local._compact_groups(q_emb, groups))
        return merge_groups(self.comm, self._timed, groups, local,
                            False, self.seq_len, self.off)

    def _compactd_groups(self, q_padded: np.ndarray, q_emb: torch.Tensor,
                         groups):
        """Every K-mode compaction dispatch of a batch on every rank's
        shard: per group, as ``ScanRunner._compactd`` returns them, (rows,
        idx, dist, counts) in (row, distance, index) order."""
        if not groups:
            return []
        local = (None if self.local is None else
                 self.local._compactd_groups(q_padded, q_emb, groups))
        return merge_groups(self.comm, self._timed, groups, local, True,
                            self.seq_len, self.off)
