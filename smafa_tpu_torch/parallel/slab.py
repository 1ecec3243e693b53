"""Out-of-core db layout on one device: the db scanned in row slabs.

Counterpart of ``smafa_tpu.parallel.slab.SlabStreamRunner``. Every pass
over the db (best-hit phase A, a K-mode cutoff pass, a compaction) runs
the port's kernels once per slab of ``slab_rows`` rows and folds the
slab results into one accumulator:

- phase A: min2 with its tie count, keys packed slab-locally, merged
  into global (dist, index, count) by ``distance.min2_pair_merge``. Only
  a slab's span must fit the 31-bit key, so any row count packs: this
  is the layout for dbs past the global key budget (2^25 windows at
  60 bp, 2^22 at 150 bp). A slab is never wider than
  ``keys.packing_span`` (2^23 rows at 127-254 bp), so every window
  length below 2^25 - 1 bp packs (longer ones take the wide route,
  ``parallel.wide``, which reads ``slab_plan`` for its slab tier);
- K-mode cutoff passes: kstats over each slab's real rows, counts summed
  and maxima taken over slabs; the histogram (``SMAFA_TPU_KMODE_HIST=1``):
  hist over each slab's real rows, summed over slabs;
- compactions: compact_mask per slab, hits offset by the slab's first
  row. All dispatches of a batch share one pass over the slabs.

Two tiers, as in ``smafa_tpu``:

- **resident**: the whole db's codes and embedded twin are held on the
  card (``resident_row_bytes`` a row) and each slab is a row view of
  them, with no copy. On when ``SMAFA_TPU_SLAB_RESIDENT`` says so (any
  value but 0/false), else when the cache takes at most
  ``CODES_RESIDENT_FRACTION`` of the card's memory;
- **streaming**: the codes stay in host memory (often the native
  format's memmap). Every pass uploads each slab through one of
  ``_INFLIGHT`` pinned staging buffers on a copy stream and embeds it on
  the card; a buffer is refilled only after the scan of the slab it last
  held has finished, so at most ``_INFLIGHT`` slabs are alive on the card
  and the next slab's copy overlaps this slab's scan.

``SMAFA_TPU_SLAB_BYTES`` sets the slab's budget in code bytes
(``SLAB_BYTES``), capped at the widest span that packs and balanced so
the last slab carries real rows.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K
from smafa_tpu_torch.ops.compact import compact_mask
from smafa_tpu_torch.ops.hist import hist
from smafa_tpu_torch.ops.kstats import kstats
from smafa_tpu_torch.ops.min2 import min2
from smafa_tpu_torch.parallel.runner import DeviceRunner, KeyPackingError
from smafa_tpu_torch.parallel.select import hbm_capacity, resident_row_bytes

logger = logging.getLogger("smafa")

SLAB_BYTES = 1 << 29   # uint8 code bytes a slab
_INFLIGHT = 4          # slabs alive on the card in the streaming tier
CODES_RESIDENT_FRACTION = 0.4


def slab_plan(n_windows: int, seq_len: int) -> tuple[int, int]:
    """(slab_rows, n_slabs): slabs of whole 64-row tiles within the byte
    budget (seq_len code bytes a row) and within ``keys.packing_span``,
    as few as they allow, balanced so the last one carries real rows
    (``smafa_tpu.parallel.slab``'s plan with chunk = 64, plus the span
    cap)."""
    m = D.WP_MULTIPLE
    budget = int(os.environ.get("SMAFA_TPU_SLAB_BYTES", str(SLAB_BYTES)))
    need = max(m, -(-n_windows // m) * m)
    budget_rows = max(m, budget // max(1, seq_len) // m * m)
    span = K.packing_span(seq_len)
    if span is not None:
        budget_rows = min(budget_rows, span)
    n_slabs = -(-need // budget_rows)
    slab_rows = -(-need // (n_slabs * m)) * m
    return slab_rows, max(1, -(-n_windows // slab_rows))


class SlabUploads:
    """The streaming tier's uploads of a db's codes held in host memory,
    shared by ``SlabStreamRunner`` and the wide route's slab tier
    (``parallel.wide``): each slab goes through one of ``_INFLIGHT``
    pinned staging buffers on a copy stream, and is embedded on the
    card. Counters: ``h2d_bytes``, ``fill_s`` (host seconds filling
    staging) and ``h2d_seconds()``. The user sets ``device``,
    ``seq_len`` and ``n_windows`` before ``_init_uploads``."""

    def _init_uploads(self, codes: np.ndarray, slab_rows: int) -> None:
        self._codes_host = codes
        self.slab_rows = slab_rows
        self.n_slabs = max(1, -(-self.n_windows // slab_rows))
        # device seconds of the code uploads (CUDA event pairs not yet
        # summed), their bytes, and the host seconds filling staging
        self.h2d_bytes = 0
        self.fill_s = 0.0
        self._h2d_s = 0.0
        self._h2d_events: list = []
        self._copy = None
        self._staging = [None] * _INFLIGHT
        self._scanned = [None] * _INFLIGHT

    def h2d_seconds(self) -> float:
        """Device seconds of the db's host-to-device copies so far (0 on
        the CPU); waits for the copies queued."""
        for start, end in self._h2d_events:
            end.synchronize()
            self._h2d_s += start.elapsed_time(end) / 1e3
        self._h2d_events = []
        return self._h2d_s

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        """A resident tier's upload of code rows (timed)."""
        t = torch.from_numpy(np.array(rows, dtype=np.uint8))
        if self.device.type != "cuda":
            return t
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = t.to(self.device)
        end.record()
        self._h2d_events.append((start, end))
        self.h2d_bytes += t.numel()
        return out

    def _upload(self, s: int, off: int, n_valid: int) -> torch.Tensor:
        """Slab s's real rows [n_valid, L] on the card, ready on the
        current stream (the streaming tier)."""
        rows = self._codes_host[off:off + n_valid]
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(rows, dtype=np.uint8))
        slot = s % _INFLIGHT
        if self._scanned[slot] is not None:
            # the slab this slot last held is scanned, so its staging
            # buffer and its device copy are free
            self._scanned[slot].synchronize()
        if self._staging[slot] is None:
            self._staging[slot] = torch.empty(
                (self.slab_rows, self.seq_len), dtype=torch.uint8,
                pin_memory=True)
        host = self._staging[slot][:n_valid]
        t0 = time.perf_counter()
        np.copyto(host.numpy(), rows)
        self.fill_s += time.perf_counter() - t0
        if self._copy is None:
            self._copy = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(self._copy):
            buf = torch.empty((n_valid, self.seq_len), dtype=torch.uint8,
                              device=self.device)
            start.record()
            buf.copy_(host, non_blocking=True)
            end.record()
        self._h2d_events.append((start, end))
        self.h2d_bytes += host.numel()
        compute.wait_event(end)
        # allocated on the copy stream, read on this one: not reused
        # before this stream's work on it is done
        buf.record_stream(compute)
        return buf

    def _stream_slabs(self, fold) -> None:
        """fold(emb, zc, codes, n_valid, off) for each slab in ascending
        order, on the current stream, uploaded and embedded: emb int8
        [slab_rows, EP] and zc int32 [slab_rows] the slab's twin, padding
        rows poisoned to distance L + 1; codes uint8 [n_valid, L] its
        real rows; off the global index of its first row."""
        for s in range(self.n_slabs):
            off = s * self.slab_rows
            n_valid = min(self.slab_rows, self.n_windows - off)
            codes = self._upload(s, off, n_valid)
            emb, zc = D.embed_db(codes, self.seq_len, self.slab_rows)
            fold(emb, zc, codes, n_valid, off)
            if codes.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                self._scanned[s % _INFLIGHT] = done


class SlabStreamRunner(SlabUploads, DeviceRunner):
    """Every hit mode of ``ScanRunner`` (identical results) over a db
    scanned slab by slab."""

    def __init__(self, codes: np.ndarray, seq_len: int, device: torch.device,
                 slab_rows: int | None = None):
        super().__init__(device)
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        if self.n_windows >= 2**31:
            raise ValueError("db indices must fit int32")
        if slab_rows is None:
            slab_rows, _ = slab_plan(self.n_windows, self.seq_len)
        if slab_rows <= 0 or slab_rows % D.WP_MULTIPLE:
            raise ValueError(f"slab_rows {slab_rows} is not a positive "
                             f"multiple of {D.WP_MULTIPLE}")
        self._init_uploads(codes, slab_rows)
        self.wp = self.n_slabs * slab_rows
        self.shift = K.packing_shift(self.seq_len, slab_rows)
        if self.shift is None:
            raise KeyPackingError(
                f"slabs of {slab_rows} windows of length {self.seq_len} do "
                "not pack into 31-bit keys (at 2^25 - 1 bp or more not "
                "even one 64-row tile does: select.make_runner builds the "
                "wide route, parallel.wide.WideRunner, for those)")
        env = os.environ.get("SMAFA_TPU_SLAB_RESIDENT", "")
        if env:
            resident = env not in ("0", "false")
        else:
            cap = hbm_capacity(self.device)
            resident = (cap is not None and self.wp * resident_row_bytes(
                self.seq_len) <= CODES_RESIDENT_FRACTION * cap)
        self.tier = "resident" if resident else "streaming"
        self.db_codes = self.db_emb = self.zc = None
        if resident:
            self.db_codes = self._to_device(codes)
            self.db_emb, self.zc = D.embed_db(self.db_codes, self.seq_len,
                                              self.wp)
        logger.debug("stream layout: %d slabs of %d rows (slab-local shift "
                     "%d), %s tier", self.n_slabs, slab_rows, self.shift,
                     self.tier)

    def _sweep(self, fold) -> None:
        """fold(emb, zc, codes, n_valid, off) for each slab in ascending
        order, as ``_stream_slabs`` gives them; in the resident tier the
        slabs are row views of the resident twin and codes."""
        if self.db_emb is None:
            self._stream_slabs(fold)
            return
        for s in range(self.n_slabs):
            off = s * self.slab_rows
            n_valid = min(self.slab_rows, self.n_windows - off)
            end = off + self.slab_rows
            fold(self.db_emb[off:end], self.zc[off:end],
                 self.db_codes[off:off + n_valid], n_valid, off)

    # -- HitModesMixin primitives ------------------------------------------

    def _compact_span_rows(self) -> int:
        return self.slab_rows

    def _phase_a(self, q_emb: torch.Tensor):
        """min2 with its count per slab, merged: (pair [3, B], cnt)."""
        carry = [D.min2_pair_init(q_emb.shape[0], q_emb.device)]

        def fold(emb, zc, _codes, _n_valid, off):
            lo, hi, cnt = min2(q_emb, emb, zc, self.seq_len, self.shift,
                               with_count=True)
            carry[0] = D.min2_pair_merge(carry[0], lo, hi, cnt, off,
                                         self.slab_rows, self.shift,
                                         self.seq_len)
        self._sweep(fold)
        return D.min2_pair_finish(carry[0])

    def _kstats(self, q_emb: torch.Tensor, ts: torch.Tensor):
        """One K-mode cutoff pass: kstats per slab over its real rows,
        counts summed and maxima taken over slabs."""
        cnt = torch.zeros(tuple(ts.shape), dtype=torch.int32,
                          device=q_emb.device)
        mx = torch.full((q_emb.shape[0],), -1, dtype=torch.int32,
                        device=q_emb.device)

        def fold(emb, zc, _codes, n_valid, _off):
            c, m = kstats(q_emb, emb, zc, ts, n_valid, self.seq_len)
            cnt.add_(c)
            torch.maximum(mx, m, out=mx)
        self._sweep(fold)
        return cnt, mx

    def _hist(self, q_emb: torch.Tensor) -> torch.Tensor:
        """The K-mode distance histogram: hist per slab over its real
        rows, summed over slabs."""
        out = torch.zeros((q_emb.shape[0], self.seq_len + 1),
                          dtype=torch.int32, device=q_emb.device)

        def fold(emb, zc, _codes, n_valid, _off):
            out.add_(hist(q_emb, emb, zc, n_valid, self.seq_len))
        self._sweep(fold)
        return out

    def _groups_on_device(self, q_emb: torch.Tensor, groups):
        """Each group's (query embeddings, thresholds) on the card."""
        out = []
        for ids, th in groups:
            sel = torch.from_numpy(ids.astype(np.int64)).to(self.device)
            out.append((q_emb.index_select(0, sel).contiguous(),
                        torch.from_numpy(np.ascontiguousarray(
                            th, dtype=np.int32)).to(self.device)))
        return out

    def _slab_hits(self, q, th, emb, zc):
        """One slab's compaction: (rows, slab-local idx, counts) of its
        hits, in (row, index) order."""
        return D.extract_mask_hits(compact_mask(q, emb, zc, th, self.seq_len))

    def _compact_groups(self, q_emb: torch.Tensor, groups):
        """Every best-hit compaction dispatch of a batch in one pass over
        the slabs: per group, (rows, idx) in (row, index) order and the
        per-row hit counts, as ``ScanRunner._compact`` returns them."""
        if not groups:
            return []
        sel = self._groups_on_device(q_emb, groups)
        parts = [[] for _ in groups]

        def fold(emb, zc, _codes, _n_valid, off):
            for (q, th), part in zip(sel, parts):
                rows, idx, counts = self._slab_hits(q, th, emb, zc)
                part.append((rows, idx + off, counts))
        self._sweep(fold)
        out = []
        for part in parts:
            rows, idx = (torch.cat([p[k] for p in part]) for k in range(2))
            # slabs ascend, so a stable sort by row keeps index order
            order = torch.sort(rows, stable=True).indices
            out.append((rows[order].cpu().numpy(), idx[order].cpu().numpy(),
                        sum(p[2] for p in part).cpu().numpy()))
        return out

    def _compactd_groups(self, q_padded: np.ndarray, q_emb: torch.Tensor,
                         groups):
        """Every K-mode compaction dispatch of a batch in one pass over
        the slabs: per group, as ``ScanRunner._compactd`` returns them,
        (rows, idx, dist, counts) in (row, distance, index) order. The
        order is a stable sort on int64 keys row * (L + 1) + dist of hits
        gathered in global index order (a packed (dist << shift) | idx
        would overflow past the key budget)."""
        if not groups:
            return []
        sel = self._groups_on_device(q_emb, groups)
        q_codes = [torch.from_numpy(np.ascontiguousarray(q_padded[ids]))
                   .to(self.device) for ids, _ in groups]
        parts = [[] for _ in groups]

        def fold(emb, zc, codes, _n_valid, off):
            for (q, th), qc, part in zip(sel, q_codes, parts):
                rows, idx, counts = self._slab_hits(q, th, emb, zc)
                part.append((rows, idx + off,
                             D.hit_distances(qc, codes, rows, idx), counts))
        self._sweep(fold)
        out = []
        for (ids, _), part in zip(groups, parts):
            rows, idx, dist = (torch.cat([p[k] for p in part])
                               for k in range(3))
            order = torch.sort(rows * (self.seq_len + 1) + dist,
                               stable=True).indices
            counts = sum(p[3] for p in part).cpu().numpy()
            out.append((np.repeat(ids, counts).astype(np.int32),
                        idx[order].cpu().numpy().astype(np.int32),
                        dist[order].cpu().numpy().astype(np.int32), counts))
        return out
