"""Best-hit hit selection on one device — a trimmed port of
``smafa_tpu.parallel.hitops.HitModesMixin`` (best-hit mode only).

Best-hit (reference lib.rs:296-313) prints every window at the row's
minimum distance, in index order:

- phase A is one min2 kernel pass: dual packed-key minima plus the
  exact tie count. Rows with a unique minimum (lowest tied index ==
  highest) are resolved outright; rows with exactly 2 ties are complete
  from the two keys.
- rows with more than 2 ties take a compaction pass: the compact_mask
  kernel at thresh = the row minimum, then ``extract_mask_hits``. Every
  buffered hit of such a row sits at its minimum, so (row, index) order
  is the emission order (as in the JAX package's ``compactd``).

The JAX package's latency-driven variants (``miditer``, ``tcount``,
``bestfull``, the tie-EMA switch, ``_SharedFetch``) give byte-identical
output under its own tests and are left out here.
"""

from __future__ import annotations

import numpy as np

from smafa_tpu_torch.ops import keys as K

# One compaction dispatch never enumerates more than this many hits;
# bigger row groups split, and a single row above it is enumerated on
# the host instead.
COMPACT_MAX = 1 << 22

# A compaction dispatch's [rows, wp/32] int32 mask stays under this many
# words (1 GiB).
MASK_WORDS_BUDGET = 1 << 28


def mask_row_cap(span_rows: int) -> int:
    """Max rows per compaction dispatch over a ``span_rows``-row scan:
    keeps the [rows, span/32] mask under MASK_WORDS_BUDGET, capped at
    2^15 rows and floored to a power of two."""
    w32 = max(1, span_rows // 32)
    cap = max(16, min(MASK_WORDS_BUDGET // w32, 1 << 15))
    return 1 << (cap.bit_length() - 1)


class HitModesMixin:
    """Best-hit host orchestration over the runner's primitives:
    ``_pad``, ``_embed_queries``, ``_phase_a(q_emb) -> (lo, hi, cnt)``,
    ``_compact(q_emb, row_ids, thresh) -> (rows, idx, counts)``, and the
    attributes seq_len, n_windows, wp, shift, _codes_host."""

    def _require_windows(self) -> None:
        if self.n_windows == 0:
            raise ValueError("Cannot query an empty database")

    def min_count_async(self, q_codes: np.ndarray):
        """Launch phase A without waiting; opaque handle for best_hit."""
        self._require_windows()
        q_padded, nq = self._pad(q_codes)
        q_emb = self._embed_queries(q_padded)
        lo, hi, cnt = self._phase_a(q_emb)
        return lo, hi, cnt, nq, q_padded, q_emb

    def _min2_unpack(self, lo: np.ndarray, hi: np.ndarray):
        """Packed keys -> (dist, idx_lo, idx_hi, found) per row."""
        big = np.int32(K.BIG_KEY)
        dist, idx_lo = K.unpack_key(lo, self.shift)
        _, idx_rev = K.unpack_key(hi, self.shift)
        idx_hi = np.where(hi == big, big, self.wp - 1 - idx_rev).astype(np.int32)
        return dist, idx_lo.astype(np.int32), idx_hi, lo != big

    def best_hit(self, q_codes: np.ndarray, max_divergence: int | None = None,
                 handle=None):
        """Exact best-hit result, flat: (min_dist [nq], counts [nq],
        flat_rows, flat_idx) in (row, subject index) order. ``counts``
        is 0 for rows filtered by max_divergence."""
        if handle is None:
            handle = self.min_count_async(q_codes)
        lo, hi, cnt, nq, q_padded, q_emb = handle
        lo = lo.cpu().numpy()[:nq]
        hi = hi.cpu().numpy()[:nq]
        dist, idx_lo, idx_hi, keep = self._min2_unpack(lo, hi)
        if max_divergence is not None:
            keep = keep & (dist <= max_divergence)
        tied = keep & (idx_lo != idx_hi)
        if not tied.any():
            counts = keep.astype(np.int32)
            return (dist, counts, np.nonzero(keep)[0].astype(np.int32),
                    idx_lo[keep].astype(np.int32))
        tied_ids = np.nonzero(tied)[0].astype(np.int32)
        tie_cnt = cnt.cpu().numpy()[:nq][tied_ids].astype(np.int64)
        counts = keep.astype(np.int64)
        counts[tied_ids] = tie_cnt
        # 2-tie rows are complete from the lowest and highest tied index
        p_rows = tied_ids[tie_cnt == 2]
        multi = tie_cnt > 2
        m_rows = m_idx = np.empty(0, np.int32)
        if multi.any():
            m_rows, m_idx = self._compact_grouped_rows(
                q_padded, q_emb, tied_ids[multi], dist[tied_ids[multi]],
                tie_cnt[multi],
            )
        u_rows = np.nonzero(keep & ~tied)[0].astype(np.int32)
        all_rows = np.concatenate([u_rows, p_rows, p_rows, m_rows])
        all_idx = np.concatenate(
            [idx_lo[u_rows], idx_lo[p_rows], idx_hi[p_rows], m_idx])
        order = np.lexsort((all_idx, all_rows))
        return (dist, counts.astype(np.int32),
                all_rows[order].astype(np.int32),
                all_idx[order].astype(np.int32))

    def _compact_grouped_rows(self, q_padded, q_emb, row_ids, thresh_vals,
                              counts):
        """Greedy row groups under two bounds: COMPACT_MAX hits per
        dispatch and the mask-memory row cap. A single row whose count
        exceeds COMPACT_MAX is enumerated on the host. Every count is
        known exactly, so each dispatch is checked against it. Returns
        flat (rows, idx) sorted by (row, index)."""
        cap = mask_row_cap(self.wp)
        n = int(row_ids.shape[0])
        out_r, out_i = [], []
        start = 0
        while start < n:
            c0 = int(counts[start])
            if c0 > COMPACT_MAX:
                gid = int(row_ids[start])
                hit_idx = self._host_enumerate_row(
                    q_padded[gid], int(thresh_vals[start]))
                if hit_idx.shape[0] != c0:
                    raise RuntimeError(
                        f"host enumeration found {hit_idx.shape[0]} hits, "
                        f"expected {c0}")
                out_r.append(np.full(c0, gid, np.int32))
                out_i.append(hit_idx)
                start += 1
                continue
            end = start + 1
            acc = c0
            while (end < n and end - start < cap
                   and int(counts[end]) <= COMPACT_MAX
                   and acc + int(counts[end]) <= COMPACT_MAX):
                acc += int(counts[end])
                end += 1
            ids = row_ids[start:end]
            rows, idx, got = self._compact(
                q_emb, ids, thresh_vals[start:end].astype(np.int32))
            if not np.array_equal(got, counts[start:end]):
                raise RuntimeError("compaction hit counts disagree with "
                                   "the phase-A tie counts")
            out_r.append(ids[rows].astype(np.int32))
            out_i.append(idx.astype(np.int32))
            start = end
        rows = np.concatenate(out_r) if out_r else np.empty(0, np.int32)
        idx = np.concatenate(out_i) if out_i else np.empty(0, np.int32)
        order = np.lexsort((idx, rows))
        return rows[order], idx[order]

    def _host_enumerate_row(self, q_row: np.ndarray, thresh: int) -> np.ndarray:
        """All window indices with distance <= thresh for ONE query row,
        ascending, in chunks so a memmap db streams through a bounded
        working set."""
        if thresh < 0:
            return np.empty(0, np.int32)
        L = self.seq_len
        q = q_row[:L]
        out = []
        step = 1 << 20
        for s in range(0, self.n_windows, step):
            d = np.asarray(self._codes_host[s:s + step])[:, :L]
            dist = L - (q == d).sum(axis=1)
            hit = np.nonzero(dist <= thresh)[0].astype(np.int32)
            out.append(hit + np.int32(s))
        return np.concatenate(out) if out else np.empty(0, np.int32)

