"""Single-device scan runner: the db resident on one ``torch.device``.

Counterpart of ``smafa_tpu.parallel.sharded.ScanRunner`` on a 1x1 mesh
(the runner ``smafa_tpu.parallel.select.make_runner`` picks for one
device). It holds the db channel codes and their embedded twin on
``self.device`` and supplies the primitives of ``HitModesMixin``; the
kernels it calls are the min2 kernel (phase A) and the compact_mask
kernel (tie enumeration). Multi-device layouts and the out-of-core
stream layout are later work (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K
from smafa_tpu_torch.ops.compact import compact_mask
from smafa_tpu_torch.ops.min2 import min2
from smafa_tpu_torch.parallel.hitops import HitModesMixin


class KeyPackingError(ValueError):
    pass


class ScanRunner(HitModesMixin):
    """Holds a db on one device and runs exact best-hit scans."""

    def __init__(self, codes: np.ndarray, seq_len: int, device: torch.device):
        self.device = torch.device(device)
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
                "pack into 31-bit keys; the top-M fallback for this case is "
                "not ported yet (see ROADMAP.md)")
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

    def _pad(self, q_codes: np.ndarray):
        q_padded, nq, _b = K.pad_batch(q_codes, multiple=1, minimum=16)
        return q_padded, nq

    def _embed_queries(self, q_padded: np.ndarray) -> torch.Tensor:
        codes = torch.from_numpy(np.ascontiguousarray(q_padded)).to(self.device)
        return D.expand_embed_query(codes, self.seq_len)

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
