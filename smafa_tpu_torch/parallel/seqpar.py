"""Column-sharded db layout over the processes of a run: each rank holds
a slice of every row's embedding.

Counterpart of ``smafa_tpu.parallel.seqpar.ColumnShardedScanRunner``,
for long windows. The db twin's EP = 4L (rounded up to 32) byte columns
are cut in whole ``K_STEP`` (32-byte) groups over the P ranks of
``comm``: rank r holds columns ``[c_r, c_{r+1})`` of every row, which
embed positions ``[c_r / 4, c_{r+1} / 4)`` of its codes (the last slice
may be empty). Every rank holds the whole batch, sliced the same way,
and every row's ``zc`` (the count of its code-0 positions; ``smafa_tpu``
folds it into ``ceil(L / 127)`` correction columns of the twin, where
the port's twin carries it apart), so no correction columns are needed.

Per chunk of db rows each rank computes its partial int32 match block
[B, chunk] over its columns; an ``all_reduce`` SUM (``psum(part,
"c")``) gives the exact matches, and ``dist = L - matches - zc``. The
distance block then folds, the same on every rank, into:

- phase A: (dist, i_lo, i_hi, count) pair carries, chunks in ascending
  order (``distance.min2_pair_fold``), so any row count packs;
- a K-mode cutoff pass: the counts at the per-row thresholds and the row
  maxima; the histogram (``SMAFA_TPU_KMODE_HIST=1``): each row's count
  at every distance;
- compactions: the hits ``dist <= thresh`` of every group of a batch,
  read straight from the block (one sweep for all groups, over the rows
  of the groups alone), in (row, index) order, in K-mode (row, distance,
  index).

Outputs are the same on every rank, so nothing else merges. Like
``smafa_tpu``'s column layout this one runs no hand-written kernel: the
partial product is ``torch._int_mm`` on the card (exact int32; k and n
multiples of 8 and m > 16, so batches are padded to 32 rows at least)
and on the CPU ``distance.dots``' float32 products, exact at any width
(one product while the slice holds at most 2^24 window positions, where
|dot| <= 2^24; past it one a block of 2^24 positions); an int8
``matmul`` is never used, since on the CPU it wraps once L >= 128. The
folds are plain torch ops on the block. A chunk's block is at most
``BLOCK_BYTES``; ``merge_s`` counts the host seconds in the all_reduces.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K
from smafa_tpu_torch.parallel import multihost
from smafa_tpu_torch.parallel.runner import DeviceRunner

logger = logging.getLogger("smafa")

# int32 bytes of one chunk's [B, chunk] match block: the chunk's rows are
# as many as fit, in whole 64-row tiles (the block, its sum and, under
# gloo, their pinned staging stay near 4 x 128 MiB)
BLOCK_BYTES = 1 << 27
# db code bytes embedded at once when the twin is built
EMBED_BYTES = 1 << 27
# rows of a batch at least (torch._int_mm takes m > 16)
MIN_BATCH = 32


def column_slice(seq_len: int, rank: int, size: int) -> tuple[int, int]:
    """Columns [c0, c1) of the twin that ``rank`` of ``size`` holds: whole
    32-byte groups, as many on every rank but the last ones, which may
    hold fewer or none."""
    ep = D.embed_width(seq_len)
    per = -(-(ep // D.K_STEP) // size) * D.K_STEP
    c0 = min(rank * per, ep)
    return c0, min(c0 + per, ep)


class ColumnShardedRunner(DeviceRunner):
    """Every hit mode of ``ScanRunner`` (identical results) over a db whose
    twin columns are sharded over the ranks of ``comm`` (default: the
    process group of ``multihost.initialize``)."""

    def __init__(self, codes: np.ndarray, seq_len: int, device: torch.device,
                 comm=None):
        super().__init__(device)
        self.comm = comm if comm is not None else multihost.comm()
        self.seq_len = L = max(1, seq_len)
        self.n_windows = n = int(codes.shape[0])
        if n >= 2**31:
            raise ValueError("db indices must fit int32")
        self._codes_host = codes
        # the mixin reads these only from packed keys; results come in the
        # pair form
        self.wp, self.shift = n, None
        self.c0, self.c1 = column_slice(L, self.comm.rank, self.comm.size)
        # codes positions [p0, p1) embed the columns [c0, c1)
        self._p0, self._p1 = min(self.c0 // 4, L), min(self.c1 // 4, L)
        wp = max(D.WP_MULTIPLE, -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE)
        # rows n..wp-1 poisoned: zero embedding, zc -1 (distance L + 1)
        self.db_emb = torch.zeros((wp, self.c1 - self.c0), dtype=torch.int8,
                                  device=self.device)
        self.zc = torch.full((wp,), -1, dtype=torch.int32, device=self.device)
        step = max(1, EMBED_BYTES // L)
        for off in range(0, n, step):
            rows = torch.from_numpy(np.array(codes[off:off + step],
                                             dtype=np.uint8)).to(self.device)
            self.zc[off:off + rows.shape[0]] = (rows == 0).sum(
                dim=1, dtype=torch.int32)
            if self.c1 > self.c0:
                self.db_emb[off:off + rows.shape[0]] = D.expand_embed_db(
                    rows[:, self._p0:self._p1], self._p1 - self._p0)[0]
        self.merge_s = 0.0
        self._chunks_logged: set[int] = set()
        logger.info("col layout: rank %d of %d holds twin columns [%d, %d) "
                    "of %d (window positions [%d, %d))", self.comm.rank,
                    self.comm.size, self.c0, self.c1, D.embed_width(L),
                    self._p0, self._p1)

    def chunk_rows(self, b: int) -> int:
        """db rows of one chunk at a batch of b rows: whole 64-row tiles
        whose [b, chunk] int32 block stays within BLOCK_BYTES."""
        m = D.WP_MULTIPLE
        rows = max(m, BLOCK_BYTES // (4 * max(1, b)) // m * m)
        return min(rows, self.db_emb.shape[0])

    def _partial(self, q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """int32 [B, rows] matches of this rank's columns."""
        if q.shape[1] == 0:
            return torch.zeros((q.shape[0], d.shape[0]), dtype=torch.int32,
                               device=q.device)
        if q.is_cuda:
            return torch._int_mm(q, d.T)
        return D.dots(q, d)

    def _sweep(self, q: torch.Tensor, fold) -> None:
        """fold(dist int32 [B, n], off) for each chunk of db rows in
        ascending order: the exact distances of the batch rows ``q`` to
        the chunk's n real rows, whose first row has the index off."""
        chunk = self.chunk_rows(q.shape[0])
        if chunk not in self._chunks_logged:
            self._chunks_logged.add(chunk)
            logger.info("col layout: chunks of %d rows at a batch of %d "
                        "(%d MiB a block)", chunk, q.shape[0],
                        4 * q.shape[0] * chunk >> 20)
        for off in range(0, self.n_windows, chunk):
            part = self._partial(q, self.db_emb[off:off + chunk])
            t0 = time.perf_counter()
            matches = self.comm.all_reduce(part, "sum")
            self.merge_s += time.perf_counter() - t0
            n = min(chunk, self.n_windows - off)
            fold(self.seq_len - matches[:, :n] - self.zc[off:off + n], off)

    # -- HitModesMixin primitives ------------------------------------------

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = K.pad_batch(q_codes, multiple=1,
                                       minimum=MIN_BATCH)
        return q_padded, nq

    def _embed_queries(self, q_padded: np.ndarray) -> torch.Tensor:
        """This rank's columns of the batch's embedding: int8 [B, c1 - c0]."""
        codes = torch.from_numpy(np.ascontiguousarray(
            q_padded[:, self._p0:self._p1])).to(self.device)
        if self.c1 == self.c0:
            return torch.zeros((codes.shape[0], 0), dtype=torch.int8,
                               device=self.device)
        return D.expand_embed_query(codes, self._p1 - self._p0)

    def _phase_a(self, q_emb: torch.Tensor):
        """(pair [3, B], cnt) of the batch."""
        acc = [D.min2_pair_init(q_emb.shape[0], q_emb.device)]

        def fold(dist, off):
            d = dist.amin(dim=1)
            at = dist == d.unsqueeze(1)
            idx = torch.arange(off, off + dist.shape[1], dtype=torch.int32,
                               device=dist.device)
            acc[0] = D.min2_pair_fold(acc[0], (
                d, torch.where(at, idx, K.BIG_KEY).amin(dim=1),
                torch.where(at, idx, -1).amax(dim=1),
                at.sum(dim=1, dtype=torch.int32)))
        self._sweep(q_emb, fold)
        return D.min2_pair_finish(acc[0])

    def _kstats(self, q_emb: torch.Tensor, ts: torch.Tensor):
        """One K-mode cutoff pass: (cnt [P, B], mx [B]) at the per-row
        thresholds ts [P, B]."""
        cnt = torch.zeros(tuple(ts.shape), dtype=torch.int32,
                          device=q_emb.device)
        mx = torch.full((q_emb.shape[0],), -1, dtype=torch.int32,
                        device=q_emb.device)

        def fold(dist, _off):
            for p in range(ts.shape[0]):
                cnt[p] += (dist <= ts[p].unsqueeze(1)).sum(dim=1,
                                                           dtype=torch.int32)
            torch.maximum(mx, dist.amax(dim=1), out=mx)
        self._sweep(q_emb, fold)
        return cnt, mx

    def _hist(self, q_emb: torch.Tensor) -> torch.Tensor:
        """The K-mode distance histogram: int32 [B, L+1]."""
        out = torch.zeros((q_emb.shape[0], self.seq_len + 1),
                          dtype=torch.int32, device=q_emb.device)

        def fold(dist, _off):
            out.scatter_add_(1, dist.to(torch.int64), torch.ones_like(dist))
        self._sweep(q_emb, fold)
        return out

    def _groups_hits(self, q_emb: torch.Tensor, groups, kmode: bool):
        """Every compaction of a batch in one sweep over the groups' rows:
        per group (rows as positions in the group, idx[, dist], counts) in
        (row, index) order, in K-mode (row, distance, index) order."""
        ids = np.concatenate([g for g, _ in groups]).astype(np.int64)
        th = np.concatenate([t for _, t in groups]).astype(np.int32)
        q = q_emb.index_select(0, torch.from_numpy(ids).to(self.device))
        if q.shape[0] < MIN_BATCH:
            q = torch.cat([q, q.new_zeros((MIN_BATCH - q.shape[0],
                                           q.shape[1]))])
        th_dev = torch.from_numpy(th).to(self.device).unsqueeze(1)
        parts = []

        def fold(dist, off):
            dist = dist[:len(ids)]
            rows, j = torch.nonzero(dist <= th_dev, as_tuple=True)
            parts.append((rows, j + off, dist[rows, j]))
        self._sweep(q.contiguous(), fold)
        rows, idx, dist = (torch.cat([p[k] for p in parts]) for k in range(3))
        # chunks ascend, so a stable sort by row keeps each row's index order
        key = rows * (self.seq_len + 1) + dist if kmode else rows
        order = torch.sort(key, stable=True).indices
        rows, idx, dist = (t[order].cpu().numpy() for t in (rows, idx, dist))
        counts = np.bincount(rows, minlength=len(ids))
        starts = np.cumsum([0] + [len(g) for g, _ in groups])
        edges = np.searchsorted(rows, starts)
        return [(rows[a:b] - s, idx[a:b], dist[a:b], counts[s:e])
                for s, e, a, b in zip(starts[:-1], starts[1:], edges[:-1],
                                      edges[1:])]

    def _compact_groups(self, q_emb: torch.Tensor, groups):
        """Every best-hit compaction dispatch of a batch: per group, (rows,
        idx) in (row, index) order and the per-row hit counts, as
        ``ScanRunner._compact`` returns them."""
        if not groups:
            return []
        return [(rows.astype(np.int32), idx.astype(np.int32), counts)
                for rows, idx, _d, counts in self._groups_hits(
                    q_emb, groups, kmode=False)]

    def _compactd_groups(self, q_padded: np.ndarray, q_emb: torch.Tensor,
                         groups):
        """Every K-mode compaction dispatch of a batch: per group, as
        ``ScanRunner._compactd`` returns them, (rows, idx, dist, counts)
        in (row, distance, index) order, rows as batch row ids."""
        if not groups:
            return []
        return [(ids[rows].astype(np.int32), idx.astype(np.int32),
                 dist.astype(np.int32), counts)
                for (ids, _), (rows, idx, dist, counts) in zip(
                    groups, self._groups_hits(q_emb, groups, kmode=True))]
