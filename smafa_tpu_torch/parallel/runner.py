"""Single-device scan runner: the db resident on one ``torch.device``.

Counterpart of ``smafa_tpu.parallel.sharded.ScanRunner`` on a 1x1 mesh.
It holds the db channel codes and their embedded twin on
``self.device`` and supplies the primitives of ``HitModesMixin``; the
kernels it calls are the min2 kernel (best-hit phase A), the kstats
kernel (the K-mode cutoff passes; the hist kernel instead under
``SMAFA_TPU_KMODE_HIST=1``) and the compact_mask kernel (tie and K-mode
hit enumeration). ``parallel.select.make_runner`` picks it while
the db's global packed keys fit 31 bits and its resident form fits the
card; past either, the stream layout (``parallel.slab``) serves, and
past a 64-row tile's keys the wide route (``parallel.wide``).
``DeviceRunner`` holds what both runners share: query padding and
embedding, and the side stream of a batch's first pass.
"""

from __future__ import annotations

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K
from smafa_tpu_torch.ops.compact import compact_mask
from smafa_tpu_torch.ops.hist import hist
from smafa_tpu_torch.ops.kstats import kstats
from smafa_tpu_torch.ops.min2 import min2
from smafa_tpu_torch.parallel.hitops import HitModesMixin


class KeyPackingError(ValueError):
    pass


class Ahead:
    """Results of a batch's first device pass, launched ahead of the
    batch before it: copies in host memory, ready once ``event`` (None on
    the CPU) has passed."""

    def __init__(self, host: list[torch.Tensor], event):
        self._host, self._event = host, event

    def numpy(self) -> list[np.ndarray]:
        """The results; waits for the pass and its copies alone."""
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


class DeviceRunner(HitModesMixin):
    """Query-side primitives of a runner on ``self.device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._side = None  # CUDA stream of the passes launched ahead

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = K.pad_batch(q_codes, multiple=1, minimum=16)
        return q_padded, nq

    def _embed_queries(self, q_padded: np.ndarray) -> torch.Tensor:
        codes = torch.from_numpy(np.ascontiguousarray(q_padded))
        return D.expand_embed_query(codes.to(self.device), self.seq_len)

    def _ahead(self, q_emb: torch.Tensor, launch) -> Ahead:
        """Run ``launch() -> tensors``, a batch's first pass over the db,
        so that reading its results waits for it alone. On a GPU it runs
        on a side stream, after the work queued so far on the current
        stream (the embedding of ``q_emb``), and its results are copied
        to pinned host memory behind it: the batch before, whose
        compaction the current stream then runs, does not queue behind
        this pass, nor does the host wait for it (the stream layout's
        streaming tier excepted: its host feeds every slab)."""
        if not q_emb.is_cuda:
            return Ahead([t.cpu() for t in launch()], None)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        q_emb.record_stream(self._side)
        with torch.cuda.stream(self._side):
            outs = launch()
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in outs]
            for h, t in zip(host, outs):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        return Ahead(host, done)


class ScanRunner(DeviceRunner):
    """Holds a db on one device and runs exact best-hit and K-mode scans."""

    def __init__(self, codes: np.ndarray, seq_len: int, device: torch.device):
        super().__init__(device)
        self.seq_len = max(1, seq_len)
        self.n_windows = int(codes.shape[0])
        # Host view of the codes (often a memmap): host enumeration of
        # giant tie rows reads it.
        self._codes_host = codes
        if self.n_windows == 0:
            # Empty dbs never reach a kernel (best_hit raises first);
            # keep the runner constructible so load-then-error works.
            self.wp = 0
            self.shift = None
            self.db_codes = self.db_emb = self.zc = None
            return
        # Db rows padded to the kernels' tile multiple; the twin poisons
        # the padding rows to distance seq_len + 1.
        self.wp = -(-self.n_windows // D.WP_MULTIPLE) * D.WP_MULTIPLE
        self.shift = K.packing_shift(self.seq_len, self.wp)
        if self.shift is None:
            raise KeyPackingError(
                f"{self.n_windows} windows of length {self.seq_len} do not "
                "pack into 31-bit global keys; select.make_runner builds "
                "the stream layout (parallel.slab), which packs them per "
                "slab, or, where not even a 64-row tile packs (windows of "
                "2^25 - 1 bp or more), the wide route "
                "(parallel.wide.WideRunner)")
        # np.array copies: the host view may be a read-only memmap
        self.db_codes = torch.from_numpy(
            np.array(codes, dtype=np.uint8)).to(self.device)
        self.db_emb, self.zc = D.embed_db(self.db_codes, self.seq_len, self.wp)
        if self.wp > self.n_windows and int(self.zc[-1]) != -1:
            # The kernels' correctness rests on poisoned padding rows.
            raise RuntimeError("embed twin padding is not poisoned "
                               f"(zc of the last row is {int(self.zc[-1])})")

    @classmethod
    def from_codes(cls, codes: np.ndarray, seq_len: int,
                   device: torch.device) -> "ScanRunner":
        """A runner over the same uint8 [W, L] code matrix that
        ``smafa_tpu.parallel.sharded.ScanRunner`` takes."""
        return cls(codes, seq_len, device)

    def _phase_a(self, q_emb: torch.Tensor):
        return min2(q_emb, self.db_emb, self.zc, self.seq_len, self.shift,
                    with_count=True)

    def _compact(self, q_emb: torch.Tensor, row_ids: np.ndarray,
                 thresh: np.ndarray):
        """One compaction dispatch over the selected batch rows: local
        (rows, idx) in (row, index) order and per-row hit counts."""
        ids = torch.from_numpy(row_ids.astype(np.int64)).to(self.device)
        th = torch.from_numpy(thresh).to(self.device)
        mask = compact_mask(q_emb.index_select(0, ids).contiguous(),
                            self.db_emb, self.zc, th, self.seq_len)
        rows, idx, counts = D.extract_mask_hits(mask)
        return rows.cpu().numpy(), idx.cpu().numpy(), counts.cpu().numpy()

    def _kstats(self, q_emb: torch.Tensor, ts: torch.Tensor):
        """One K-mode cutoff pass over the db's real rows: (cnt [P, B],
        mx [B]) at the per-row thresholds ts [P, B]."""
        return kstats(q_emb, self.db_emb, self.zc, ts, self.n_windows,
                      self.seq_len)

    def _hist(self, q_emb: torch.Tensor) -> torch.Tensor:
        """The K-mode distance histogram over the db's real rows: int32
        [B, L+1]."""
        return hist(q_emb, self.db_emb, self.zc, self.n_windows, self.seq_len)

    def _compactd(self, q_padded: np.ndarray, q_emb: torch.Tensor,
                  row_ids: np.ndarray, thresh: np.ndarray):
        """One K-mode compaction dispatch over the selected batch rows:
        every hit at dist <= thresh with its distance, in (row, distance,
        index) order. Returns host (rows, idx, dist) int32, rows as batch
        row ids, and the per-row hit counts."""
        ids = torch.from_numpy(row_ids.astype(np.int64)).to(self.device)
        th = torch.from_numpy(thresh.astype(np.int32)).to(self.device)
        mask = compact_mask(q_emb.index_select(0, ids).contiguous(),
                            self.db_emb, self.zc, th, self.seq_len)
        rows, idx, counts = D.extract_mask_hits(mask)
        del mask
        q_sel = torch.from_numpy(np.ascontiguousarray(q_padded[row_ids]))
        dist = D.hit_distances(q_sel.to(self.device), self.db_codes, rows, idx)
        keys = D.sort_hit_keys(rows, (dist.to(torch.int64) << self.shift) | idx)
        keys = keys.cpu().numpy()
        counts = counts.cpu().numpy()
        return (np.repeat(row_ids, counts).astype(np.int32),
                (keys & ((1 << self.shift) - 1)).astype(np.int32),
                (keys >> self.shift).astype(np.int32), counts)
