"""Ring db layout over the processes of a run: db shards rotate around
the ranks.

Counterpart of ``smafa_tpu.parallel.ring.RingScanRunner``. Both the
query batch and the db rows are sharded over the P ranks of ``comm``:

- rank r owns the rows ``sharded.shard_range(n_windows, r, P)``, whole
  64-row tiles, ``shard_rows`` rows a shard on every rank (the last
  shards may hold fewer real rows, or none); it reads only those rows
  from the host view, and ``_codes_host`` stays the whole view, for the
  host enumeration of giant tie rows;
- each batch is padded to a multiple of P, and rank r scans rows
  ``[r * B/P, (r + 1) * B/P)`` of it, its block.

A pass over the db is P steps. At step i a rank holds the shard of rank
``(r - i) mod P``, whose first row has the global index ``((r - i) mod
P) * shard_rows``; it scans its block against that shard with the
port's kernels, then passes the shard's uint8 codes to rank r + 1 and
takes rank r - 1's (``Comm.rotate``: codes move 4L / L times fewer
bytes than the int8 twin, as ``smafa_tpu`` rotates codes). The last
rotation of a pass is skipped. Every rank rotates P - 1 times a pass,
whether its block is all padding or the shard it holds is empty.

The twin the kernels read: the rank's own shard's, embedded once (step 0
of every pass), and a buffer for the arriving shards, embedded at each
later step with its padding rows poisoned (``distance.embed_db_into``),
so a sweep holds its own shard and the one arriving, never the db. Each
CUDA stream that sweeps has a buffer of its own: a batch's first pass
runs on a side stream while the batch before compacts on the current
one (``DeviceRunner._ahead``), and at a given step the two sweeps hold
different owners' shards once P > 2. A rank so holds at most two
arriving shards beside its own.

- phase A: min2 with its count per step, keys packed shard-locally at
  ``packing_shift(L, shard_rows)`` and decoded with the owner's offset
  (``distance.min2_pair_merge``); the owners' carries are folded in
  ascending owner order after the sweep (``distance.min2_pair_fold``:
  ties keep the lower ``i_lo`` and the higher ``i_hi``, counts add), and
  the blocks' [4, B/P] carries are gathered, so every rank holds the
  batch's result. Only a shard's span must pack, so this one path serves
  dbs past the global key budget (``smafa_tpu``'s pair mode);
- a K-mode cutoff pass: kstats per step over the held shard's real rows,
  counts summed and maxima taken over the steps, then the blocks
  gathered; the histogram (``SMAFA_TPU_KMODE_HIST=1``) likewise, hist
  summed over the steps;
- compactions: every group of a batch shares one rotation. At each step
  compact_mask runs over the held shard for each group's rows that lie
  in the rank's block, the hits offset by the owner's first row (in
  K-mode with their distances from the held shard's codes); after the
  sweep every rank's hits are gathered and sorted by (row, index), in
  K-mode by (row, distance, index) (``sharded.merge_groups``, the
  row-sharded layout's merge).

Counters (host side): ``rotations``, ``rotate_bytes`` and ``rotate_s``
(seconds in ``rotate``), and ``merge_s`` (seconds in the gathers), as in
``ShardedRunner``. Under NCCL both seconds are the host's enqueue time;
under gloo they include the staging through host memory and the wait for
the peers.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K
from smafa_tpu_torch.ops.compact import compact_mask
from smafa_tpu_torch.ops.hist import hist
from smafa_tpu_torch.ops.kstats import kstats
from smafa_tpu_torch.ops.min2 import min2
from smafa_tpu_torch.parallel import multihost
from smafa_tpu_torch.parallel.runner import DeviceRunner, KeyPackingError
from smafa_tpu_torch.parallel.sharded import (merge_groups, shard_range,
                                               shard_rows)

logger = logging.getLogger("smafa")


class RingRunner(DeviceRunner):
    """Every hit mode of ``ScanRunner`` (identical results) over a db whose
    shards rotate around the ranks of ``comm`` (default: the process
    group of ``multihost.initialize``)."""

    def __init__(self, codes: np.ndarray, seq_len: int, device: torch.device,
                 comm=None):
        super().__init__(device)
        self.comm = comm if comm is not None else multihost.comm()
        self.seq_len = L = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        if self.n_windows >= 2**31:
            raise ValueError("db indices must fit int32")
        self._codes_host = codes
        size = self.comm.size
        self.shard_rows = max(D.WP_MULTIPLE, shard_rows(self.n_windows, size))
        self.off, self.n_local = shard_range(self.n_windows, self.comm.rank,
                                             size)
        self.local_shift = K.packing_shift(L, self.shard_rows)
        if self.local_shift is None:
            raise KeyPackingError(
                f"shards of {self.shard_rows} windows of length {L} do not "
                "pack into 31-bit keys; the sharded layout serves them (in "
                "narrower slabs, or on the wide route where not even a "
                "64-row tile packs)")
        # the mixin reads these only from packed keys; merged results come
        # in the pair form
        self.wp, self.shift = self.n_windows, None
        self._own = torch.zeros((self.shard_rows, L), dtype=torch.uint8,
                                device=self.device)
        self._own[:self.n_local] = torch.from_numpy(np.array(
            codes[self.off:self.off + self.n_local], dtype=np.uint8)).to(
                self.device)
        self._own_emb, self._own_zc = D.embed_db(self._own[:self.n_local], L,
                                                 self.shard_rows)
        # per CUDA stream (None on the CPU): the arriving shards' twin
        self._arriving: dict = {}
        self.rotations = self.rotate_bytes = 0
        self.rotate_s = self.merge_s = 0.0
        logger.info("ring layout: rank %d of %d holds rows [%d, %d), shards "
                    "of %d rows rotate", self.comm.rank, size, self.off,
                    self.off + self.n_local, self.shard_rows)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.merge_s += time.perf_counter() - t0

    def _rotate(self, held: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        try:
            return self.comm.rotate(held)
        finally:
            self.rotate_s += time.perf_counter() - t0
            self.rotations += 1
            self.rotate_bytes += held.numel()

    def _sweep(self, fold) -> None:
        """One pass: fold(emb, zc, codes, n_valid, off, owner) for each
        shard the rank holds, in ring order, skipping empty shards: emb
        int8 [shard_rows, EP] and zc int32 [shard_rows] its twin, padding
        rows poisoned to distance L + 1; codes uint8 [n_valid, L] its real
        rows; off the global index of its first row; owner its rank."""
        size, rank = self.comm.size, self.comm.rank
        held = self._own
        for i in range(size):
            owner = (rank - i) % size
            off = owner * self.shard_rows
            n_valid = min(max(self.n_windows - off, 0), self.shard_rows)
            if n_valid:
                if i == 0:
                    emb, zc = self._own_emb, self._own_zc
                else:
                    emb, zc = self._arriving_twin()
                    D.embed_db_into(held[:n_valid], self.seq_len, emb, zc)
                fold(emb, zc, held[:n_valid], n_valid, off, owner)
            if i < size - 1:
                held = self._rotate(held)

    def _arriving_twin(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(emb, zc): the current stream's buffer for the arriving shards,
        allocated at its first use on that stream."""
        key = (torch.cuda.current_stream(self.device).cuda_stream
               if self.device.type == "cuda" else None)
        if key not in self._arriving:
            self._arriving[key] = (torch.empty_like(self._own_emb),
                                   torch.empty_like(self._own_zc))
        return self._arriving[key]

    def _rows(self, b: int) -> tuple[int, int]:
        """The rank's block [lo, hi) of a padded batch of b rows."""
        per = b // self.comm.size
        return self.comm.rank * per, (self.comm.rank + 1) * per

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's [..., B/P] block, concatenated in rank order."""
        return torch.cat(self._timed(self.comm.all_gather, t), dim=-1)

    # -- HitModesMixin primitives ------------------------------------------

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = K.pad_batch(q_codes, multiple=self.comm.size,
                                       minimum=16)
        return q_padded, nq

    def _compact_span_rows(self) -> int:
        return self.shard_rows

    def _phase_a(self, q_emb: torch.Tensor):
        """(pair [3, B], cnt) of the whole batch on every rank."""
        lo_row, hi_row = self._rows(q_emb.shape[0])
        blk = q_emb[lo_row:hi_row]
        init = D.min2_pair_init(blk.shape[0], q_emb.device)
        owners = {}

        def fold(emb, zc, _codes, _n_valid, off, owner):
            lo, hi, cnt = min2(blk, emb, zc, self.seq_len, self.local_shift,
                               with_count=True)
            owners[owner] = D.min2_pair_merge(
                init, lo, hi, cnt, off, self.shard_rows, self.local_shift,
                self.seq_len)
        self._sweep(fold)
        acc = init
        for owner in sorted(owners):  # ascending index ranges
            acc = D.min2_pair_fold(acc, owners[owner])
        return D.min2_pair_finish(tuple(self._gather_rows(torch.stack(acc))))

    def _kstats(self, q_emb: torch.Tensor, ts: torch.Tensor):
        """One K-mode cutoff pass: the block's counts and maxima over every
        shard, then the blocks gathered: (cnt [P, B], mx [B])."""
        lo_row, hi_row = self._rows(q_emb.shape[0])
        blk = q_emb[lo_row:hi_row]
        tb = ts[:, lo_row:hi_row].contiguous()
        cnt = torch.zeros(tuple(tb.shape), dtype=torch.int32,
                          device=q_emb.device)
        mx = torch.full((blk.shape[0],), -1, dtype=torch.int32,
                        device=q_emb.device)

        def fold(emb, zc, _codes, n_valid, _off, _owner):
            c, m = kstats(blk, emb, zc, tb, n_valid, self.seq_len)
            cnt.add_(c)
            torch.maximum(mx, m, out=mx)
        self._sweep(fold)
        both = self._gather_rows(torch.cat([cnt, mx[None]]))
        return both[:-1].contiguous(), both[-1].contiguous()

    def _hist(self, q_emb: torch.Tensor) -> torch.Tensor:
        """The K-mode distance histogram: the block's over every shard,
        then the blocks gathered: int32 [B, L+1]."""
        lo_row, hi_row = self._rows(q_emb.shape[0])
        blk = q_emb[lo_row:hi_row]
        out = torch.zeros((blk.shape[0], self.seq_len + 1),
                          dtype=torch.int32, device=q_emb.device)

        def fold(emb, zc, _codes, n_valid, _off, _owner):
            out.add_(hist(blk, emb, zc, n_valid, self.seq_len))
        self._sweep(fold)
        return torch.cat(self._timed(self.comm.all_gather, out))

    def _groups_hits(self, q_padded, q_emb: torch.Tensor, groups,
                     kmode: bool):
        """Every compaction of a batch in one rotation, merged over the
        ranks (``sharded.merge_groups``): per group, (rows, idx[, dist],
        counts) in (row, index) order, in K-mode (row, distance, index)
        order; rows are positions in the group, in K-mode batch row ids."""
        lo_row, hi_row = self._rows(q_emb.shape[0])
        sel = []
        for ids, th in groups:
            p0, p1 = np.searchsorted(ids, [lo_row, hi_row])
            mine = torch.from_numpy(ids[p0:p1].astype(np.int64)).to(
                self.device)
            sel.append((
                p0, p1, q_emb.index_select(0, mine).contiguous(),
                torch.from_numpy(np.ascontiguousarray(
                    th[p0:p1], dtype=np.int32)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(q_padded[ids[p0:p1]]))
                .to(self.device) if kmode else None))
        parts = [[] for _ in groups]

        def fold(emb, zc, codes, _n_valid, off, _owner):
            for (p0, p1, q, th, qc), part in zip(sel, parts):
                if p1 == p0:
                    continue
                rows, idx, counts = D.extract_mask_hits(
                    compact_mask(q, emb, zc, th, self.seq_len))
                dist = (D.hit_distances(qc, codes, rows, idx) if kmode
                        else None)
                part.append((rows, idx + off, dist, counts))
        self._sweep(fold)

        # this rank's hits, its block's rows of each group, in the ring
        # order of the owners: merge_groups sorts them
        local = []
        for (ids, _), (p0, p1, *_), part in zip(groups, sel, parts):
            cols = [np.empty(0, np.int64)] * (3 if kmode else 2)
            counts = np.zeros(len(ids), np.int64)
            if part:
                cols = [torch.cat([p[k] for p in part]).cpu().numpy()
                        .astype(np.int64) for k in range(len(cols))]
                cols[0] = (ids[p0 + cols[0]] if kmode else p0 + cols[0])
                counts[p0:p1] = sum(p[3] for p in part).cpu().numpy()
            local.append((*cols, counts))
        return merge_groups(self.comm, self._timed, groups, local, kmode,
                            self.seq_len)

    def _compact_groups(self, q_emb: torch.Tensor, groups):
        """Every best-hit compaction dispatch of a batch: per group, (rows,
        idx) in (row, index) order and the per-row hit counts, as
        ``ScanRunner._compact`` returns them."""
        if not groups:
            return []
        return self._groups_hits(None, q_emb, groups, kmode=False)

    def _compactd_groups(self, q_padded: np.ndarray, q_emb: torch.Tensor,
                         groups):
        """Every K-mode compaction dispatch of a batch: per group, as
        ``ScanRunner._compactd`` returns them, (rows, idx, dist, counts)
        in (row, distance, index) order."""
        if not groups:
            return []
        return self._groups_hits(q_padded, q_emb, groups, kmode=True)
