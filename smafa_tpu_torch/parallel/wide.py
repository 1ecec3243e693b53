"""The wide route on one device: windows of 2^25 - 1 bp or more, where
not even one 64-row tile packs a 31-bit key ``(dist << shift) | idx``
(``keys.wide_route``).

``smafa_tpu`` serves these windows with its exact top-M sort-merge
(``topm_scan``, widened by ``engine.query._scan_batch``), whose step is
an int32 distance block. At these widths a batch's work is almost all
contraction, and both sides are small: a read embeds to 4L bytes (134 MB
at 2^25 bp), so a batch is tens of reads, and a db row takes EP + 4
bytes on the card, so one card holds a few hundred rows. So this runner
computes each batch's exact int32 distance block [B, W] once, with the
dist_block kernel (``ops.dist_block``), and serves every hook of
``HitModesMixin`` from it with exact integer torch ops on the device:

- phase A: the pair form (dist, i_lo, i_hi) of the row minimum, its
  lowest and highest index, and the count of windows at it;
- a K-mode cutoff pass: the counts at the probes and the row maximum, so
  the search's passes read the cached block, not the db;
- compactions: the hits ``dist <= thresh`` in (row, index) order; in
  K-mode sorted by int64 keys row * (L + 1) + dist, stably, so by (row,
  distance, index). No packed key is built on this route.

The block of the last two batches is kept (one batch in flight while the
one before resolves), keyed by the batch's query embedding.

Two tiers, as the stream layout has:

- **resident**: the db's embedded twin (int8 [Wp, EP] and its int32
  ``zc``) is held on the card, when the card's memory is known
  (``select.hbm_capacity``) and the twin fits ``select.HBM_FRACTION`` of
  it; the codes are uploaded and embedded in slabs at construction;
- **slabs**: otherwise each batch's block is computed slab by slab
  (``slab.slab_plan``: ``SMAFA_TPU_SLAB_BYTES`` of codes a slab, whole
  64-row tiles): a slab's codes are uploaded through the stream
  layout's pinned staging, the next slab's copy overlapping this one's
  scan (``slab.SlabUploads``), embedded and scanned by the same kernel.
  Nothing is read at construction.

Both tiers count their uploads as the stream layout does (``h2d_bytes``,
``fill_s``, ``h2d_seconds()``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops.dist_block import dist_block
from smafa_tpu_torch.parallel.runner import DeviceRunner
from smafa_tpu_torch.parallel.select import HBM_FRACTION, hbm_capacity
from smafa_tpu_torch.parallel.slab import SlabUploads, slab_plan

logger = logging.getLogger("smafa")

_KEPT = 2  # batches whose block stays cached


def _tiles(n: int) -> int:
    """n rows rounded up to whole 64-row tiles."""
    return -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE


class WideRunner(SlabUploads, DeviceRunner):
    """Every hit mode of ``ScanRunner`` (identical results) from exact
    int32 distance blocks."""

    def __init__(self, codes: np.ndarray, seq_len: int,
                 device: torch.device):
        super().__init__(device)
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        if self.n_windows >= 2**31:
            raise ValueError("db indices must fit int32")
        self.wp = _tiles(self.n_windows)
        self.shift = None  # phase A answers in the pair form
        self._init_uploads(codes, slab_plan(self.n_windows, self.seq_len)[0])
        self._blocks: list[tuple[torch.Tensor, torch.Tensor]] = []
        cap = hbm_capacity(self.device)
        twin = self.wp * (D.embed_width(self.seq_len) + 4)
        self.tier = ("resident" if cap is not None and self.n_windows
                     and twin <= HBM_FRACTION * cap else "slabs")
        self.db_emb = self.zc = None
        if self.tier == "resident":
            self.db_emb = torch.empty((self.wp, D.embed_width(self.seq_len)),
                                      dtype=torch.int8, device=self.device)
            self.zc = torch.empty((self.wp,), dtype=torch.int32,
                                  device=self.device)
            for s in range(self.n_slabs):
                off = s * self.slab_rows
                end = min(off + self.slab_rows, self.n_windows)
                D.embed_db_into(self._to_device(codes[off:end]),
                                self.seq_len, self.db_emb[off:end],
                                self.zc[off:end])
            self.db_emb[self.n_windows:].zero_()
            self.zc[self.n_windows:] = -1
        logger.debug("wide route: %d windows of length %d, %s tier (%d "
                     "slabs of %d rows)", self.n_windows, self.seq_len,
                     self.tier, self.n_slabs, self.slab_rows)

    def _compute(self, q_emb: torch.Tensor) -> torch.Tensor:
        """int32 [B, n_windows] exact distances of the batch."""
        if self.db_emb is not None:
            return dist_block(q_emb, self.db_emb, self.zc,
                              self.seq_len)[:, :self.n_windows]
        out = torch.empty((q_emb.shape[0], self.n_windows), dtype=torch.int32,
                          device=self.device)

        def fold(emb, zc, _codes, n_valid, off):
            out[:, off:off + n_valid] = dist_block(
                q_emb, emb, zc, self.seq_len)[:, :n_valid]
        self._stream_slabs(fold)
        return out

    def _block(self, q_emb: torch.Tensor) -> torch.Tensor:
        """The batch's distance block, computed once. A block made on
        another stream (a batch's first pass runs on a side stream) is
        recorded on this one, so its memory outlives the reads queued
        here."""
        for q, blk in self._blocks:
            if q is q_emb:
                if blk.is_cuda:
                    blk.record_stream(torch.cuda.current_stream(self.device))
                return blk
        blk = self._compute(q_emb)
        self._blocks = [(q_emb, blk)] + self._blocks[:_KEPT - 1]
        return blk

    def _rows(self, q_emb: torch.Tensor, row_ids: np.ndarray,
              thresh: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The selected rows' block and their hit mask at thresh."""
        ids = torch.from_numpy(row_ids.astype(np.int64)).to(self.device)
        th = torch.from_numpy(thresh.astype(np.int32)).to(self.device)
        sub = self._block(q_emb).index_select(0, ids)
        return sub, sub <= th.unsqueeze(1)

    # -- HitModesMixin primitives ------------------------------------------

    def _phase_a(self, q_emb: torch.Tensor):
        """(pair [3, B] = (dist, i_lo, i_hi), count) from the block."""
        blk = self._block(q_emb)
        dist = blk.amin(dim=1)
        at = blk == dist.unsqueeze(1)
        idx = torch.arange(self.n_windows, dtype=torch.int32,
                           device=self.device)
        i_lo = torch.where(at, idx, self.n_windows).amin(dim=1)
        i_hi = torch.where(at, idx, -1).amax(dim=1)
        return (torch.stack([dist, i_lo, i_hi]).to(torch.int32),
                at.sum(dim=1, dtype=torch.int32))

    def _kstats(self, q_emb: torch.Tensor, ts: torch.Tensor):
        """One K-mode cutoff pass: (cnt [P, B], mx [B]) at the per-row
        thresholds ts [P, B], from the block."""
        blk = self._block(q_emb)
        cnt = torch.stack([(blk <= ts[p].unsqueeze(1)).sum(
            dim=1, dtype=torch.int32) for p in range(ts.shape[0])])
        return cnt, blk.amax(dim=1)

    def _compact(self, q_emb: torch.Tensor, row_ids: np.ndarray,
                 thresh: np.ndarray):
        """(rows, idx) of the hits in (row, index) order, rows local to
        row_ids, and the per-row hit counts."""
        _, hit = self._rows(q_emb, row_ids, thresh)
        rows, idx = torch.nonzero(hit, as_tuple=True)
        return (rows.cpu().numpy(), idx.cpu().numpy(),
                hit.sum(dim=1).cpu().numpy())

    def _compactd(self, q_padded: np.ndarray, q_emb: torch.Tensor,
                  row_ids: np.ndarray, thresh: np.ndarray):
        """Every hit at dist <= thresh with its distance, in (row,
        distance, index) order: host (rows, idx, dist) int32, rows as
        batch row ids, and the per-row hit counts."""
        sub, hit = self._rows(q_emb, row_ids, thresh)
        rows, idx = torch.nonzero(hit, as_tuple=True)  # index order a row
        dist = sub[rows, idx]
        order = torch.sort(rows * (self.seq_len + 1) + dist,
                           stable=True).indices
        counts = hit.sum(dim=1).cpu().numpy()
        return (np.repeat(row_ids, counts).astype(np.int32),
                idx[order].cpu().numpy().astype(np.int32),
                dist[order].cpu().numpy().astype(np.int32), counts)

