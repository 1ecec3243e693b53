"""Hit selection on one device — a trimmed port of
``smafa_tpu.parallel.hitops.HitModesMixin`` (best-hit and K-mode).

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

K-mode (reference lib.rs:241-295) prints every window at distance <=
min(cutoff, max_divergence), cutoff the K-th smallest distance (the row
max when K exceeds the window count), in (distance, index) order:

- the cutoff search is kstats_steps(L) kstats kernel passes, queued on
  the device with nothing read back (``distance.kmode_phase1``); it
  gives each row's effective cutoff and exact hit count. Under
  ``SMAFA_TPU_KMODE_HIST=1``, for windows below ``keys.HIST_MAX``, one
  hist kernel pass gives each row's [L + 1] distance histogram instead,
  and the same two numbers are read off its cumulative sum on the device
  (``distance.kmode_cutoffs_from_hist``), as ``smafa_tpu`` switches;
- one compaction per row group at thresh = the row's cutoff, with the
  hits' distances recomputed from the codes and sorted by (row,
  distance, index) on the device (the JAX package's ``compactd``).

The JAX package's latency-driven variants (``miditer``, ``tcount``,
``bestfull``, the tie-EMA switch, ``_SharedFetch``) give byte-identical
output under its own tests and are left out here, as is the top-M
fallback (the stream layout and the wide route, ``parallel.wide``,
serve its inputs).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K

# One compaction dispatch never enumerates more than this many hits;
# bigger row groups split, and a single row above it is enumerated on
# the host instead.
COMPACT_MAX = 1 << 22

# A compaction dispatch's [rows, wp/32] int32 mask stays under this many
# words (1 GiB).
MASK_WORDS_BUDGET = 1 << 28

# Code bytes a step of the host enumeration of one row reads (2^20 rows
# a step up to 64 bp).
HOST_STEP_BYTES = 1 << 26


def mask_row_cap(span_rows: int) -> int:
    """Max rows per compaction dispatch over a ``span_rows``-row scan:
    keeps the [rows, span/32] mask under MASK_WORDS_BUDGET, capped at
    2^15 rows and floored to a power of two."""
    w32 = max(1, span_rows // 32)
    cap = max(16, min(MASK_WORDS_BUDGET // w32, 1 << 15))
    return 1 << (cap.bit_length() - 1)


class HitModesMixin:
    """Host orchestration over the runner's primitives: ``_pad``,
    ``_embed_queries``, ``_ahead(q_emb, launch) -> Ahead`` (a batch's
    first pass, read back without waiting for later work),
    ``_phase_a(q_emb)`` -> packed keys ``(lo, hi, cnt)`` or the pair form
    ``(pair [3, B], cnt)`` (``distance.min2_pair_finish``),
    ``_compact(q_emb, row_ids, thresh) -> (rows, idx, counts)``,
    ``_kstats(q_emb, ts) -> (cnt, mx)``, ``_hist(q_emb) -> int32 [B,
    L+1]`` (windows below ``keys.HIST_MAX``), ``_compactd(q_padded, q_emb,
    row_ids, thresh) -> (rows, idx, dist, counts)``, ``_compact_span_rows()``
    (the db rows one compaction mask spans), and the attributes seq_len,
    n_windows, wp, shift, _codes_host. A runner that scans the db in
    slabs overrides ``_compact_groups`` / ``_compactd_groups`` to run
    every dispatch of a batch in one pass over the slabs."""

    def _require_windows(self) -> None:
        if self.n_windows == 0:
            raise ValueError("Cannot query an empty database")

    def min_count_async(self, q_codes: np.ndarray):
        """Launch phase A without waiting; opaque handle for best_hit."""
        self._require_windows()
        q_padded, nq = self._pad(q_codes)
        q_emb = self._embed_queries(q_padded)
        keys = self._ahead(q_emb, lambda: self._phase_a(q_emb))
        return keys, nq, q_padded, q_emb

    def _min2_unpack(self, lo: np.ndarray, hi: np.ndarray | None = None):
        """Phase A's result -> (dist, idx_lo, idx_hi, found) per row, from
        packed keys ``lo``, ``hi``, or from the pair form ``lo`` = [3, nq]
        (dist, idx_lo, idx_hi) of global indices with ``hi`` None (the
        stream layout, whose keys pack slab-locally). Rows with no window
        read dist 2^30, idx 2^31 - 1 on both sides, found False."""
        big = np.int32(K.BIG_KEY)
        if hi is None:
            dist, idx_lo, idx_hi = lo
            return dist, idx_lo, idx_hi, dist < K.BIG
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
        keys, nq, q_padded, q_emb = handle
        *keys, cnt = (a[..., :nq] for a in keys.numpy())
        dist, idx_lo, idx_hi, keep = self._min2_unpack(*keys)
        if max_divergence is not None:
            keep = keep & (dist <= max_divergence)
        tied = keep & (idx_lo != idx_hi)
        if not tied.any():
            counts = keep.astype(np.int32)
            return (dist, counts, np.nonzero(keep)[0].astype(np.int32),
                    idx_lo[keep].astype(np.int32))
        tied_ids = np.nonzero(tied)[0].astype(np.int32)
        tie_cnt = cnt[tied_ids].astype(np.int64)
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

    def _row_groups(self, counts: np.ndarray):
        """Greedy groups of consecutive rows under two bounds: COMPACT_MAX
        hits per dispatch and the mask-memory row cap. Yields (start,
        end, on_host): a single row whose count exceeds COMPACT_MAX is a
        group of its own, enumerated on the host."""
        cap = mask_row_cap(self._compact_span_rows())
        n = int(counts.shape[0])
        start = 0
        while start < n:
            acc = int(counts[start])
            if acc > COMPACT_MAX:
                yield start, start + 1, True
                start += 1
                continue
            end = start + 1
            while (end < n and end - start < cap
                   and acc + int(counts[end]) <= COMPACT_MAX):
                acc += int(counts[end])
                end += 1
            yield start, end, False
            start = end

    def _host_row(self, q_row: np.ndarray, thresh: int, count: int):
        """Host enumeration of one giant row, checked against its known
        exact count."""
        hit_idx = self._host_enumerate_row(q_row, thresh)
        if hit_idx.shape[0] != count:
            raise RuntimeError(f"host enumeration found {hit_idx.shape[0]} "
                               f"hits, expected {count}")
        return hit_idx

    def _compact_span_rows(self) -> int:
        """Db rows one compaction mask spans: the whole padded db here;
        a slab for the stream layout."""
        return self.wp

    def _compact_groups(self, q_emb, groups):
        """One compaction per (row_ids, thresh) group: a list of ``_compact``
        results."""
        return [self._compact(q_emb, ids, th) for ids, th in groups]

    def _compactd_groups(self, q_padded, q_emb, groups):
        """One K-mode compaction per (row_ids, thresh) group: a list of
        ``_compactd`` results."""
        return [self._compactd(q_padded, q_emb, ids, th) for ids, th in groups]

    def _compact_grouped_rows(self, q_padded, q_emb, row_ids, thresh_vals,
                              counts):
        """Enumerate rows with known exact counts, one compaction per
        group of ``_row_groups``; each dispatch is checked against the
        counts. Returns flat (rows, idx) sorted by (row, index)."""
        out_r, out_i, groups, spans = [], [], [], []
        for start, end, on_host in self._row_groups(counts):
            if on_host:
                gid = int(row_ids[start])
                c0 = int(counts[start])
                out_r.append(np.full(c0, gid, np.int32))
                out_i.append(self._host_row(q_padded[gid],
                                            int(thresh_vals[start]), c0))
                continue
            groups.append((row_ids[start:end],
                           thresh_vals[start:end].astype(np.int32)))
            spans.append((start, end))
        for (start, end), (ids, _), (rows, idx, got) in zip(
                spans, groups, self._compact_groups(q_emb, groups)):
            if not np.array_equal(got, counts[start:end]):
                raise RuntimeError("compaction hit counts disagree with "
                                   "the phase-A tie counts")
            out_r.append(ids[rows].astype(np.int32))
            out_i.append(idx.astype(np.int32))
        rows = np.concatenate(out_r) if out_r else np.empty(0, np.int32)
        idx = np.concatenate(out_i) if out_i else np.empty(0, np.int32)
        order = np.lexsort((idx, rows))
        return rows[order], idx[order]

    # -- K-mode ------------------------------------------------------------

    def _kmode_hist_enabled(self) -> bool:
        """``smafa_tpu``'s switch of the cutoff program: the histogram
        under SMAFA_TPU_KMODE_HIST=1 for windows below HIST_MAX, else
        the kstats search."""
        return (self.seq_len < K.HIST_MAX
                and os.environ.get("SMAFA_TPU_KMODE_HIST", "") == "1")

    def kmode_stats_async(self, q_codes: np.ndarray, k: int,
                          max_divergence: int | None):
        """Launch the K-mode cutoff search (or the histogram pass, see
        ``_kmode_hist_enabled``) without waiting; opaque handle for
        kmode_flat."""
        self._require_windows()
        q_padded, nq = self._pad(q_codes)
        q_emb = self._embed_queries(q_padded)
        # Both flags take any u32 (reference main.rs:87-97) and meet int32
        # counts and distances on the device: every K above the window
        # count acts alike, and no distance exceeds L, so L + 1 stands
        # for "no divergence filter".
        k = min(k, self.n_windows + 1)
        maxdiv = self.seq_len + 1
        if max_divergence is not None:
            maxdiv = min(maxdiv, max_divergence)
        if self._kmode_hist_enabled():
            stats = self._ahead(q_emb, lambda: D.kmode_cutoffs_from_hist(
                self._hist(q_emb), k, maxdiv, self.n_windows))
        else:
            stats = self._ahead(q_emb, lambda: D.kmode_phase1(
                lambda ts: self._kstats(q_emb, ts), k, maxdiv,
                self.n_windows, self.seq_len, q_emb.shape[0], q_emb.device))
        return stats, nq, q_padded, q_emb

    def kmode_flat(self, q_codes: np.ndarray, k: int,
                   max_divergence: int | None, stats_handle=None):
        """Exact K-mode hit lists, flat: (counts [nq], flat_rows,
        flat_idx, flat_dist) int32 with each row's segment sorted by
        (distance, subject index) — the reference's print set and order
        (lib.rs:241-295 before limit-per-sequence), cutoff ties
        included."""
        if stats_handle is None:
            stats_handle = self.kmode_stats_async(q_codes, k, max_divergence)
        stats, nq, q_padded, q_emb = stats_handle
        eff, hits = (a[:nq] for a in stats.numpy())
        counts = hits.astype(np.int64)
        sel = np.nonzero(counts > 0)[0].astype(np.int32)
        # pieces in row order: host rows are enumerated here, device
        # groups all go to one _compactd_groups call (None placeholders)
        pieces, groups = [], []
        for start, end, on_host in self._row_groups(counts[sel]):
            if on_host:
                gid = int(sel[start])
                c0 = int(counts[gid])
                hit_idx = self._host_row(q_padded[gid], int(eff[gid]), c0)
                dv = D.hit_distances(
                    torch.from_numpy(q_padded[gid:gid + 1]),
                    torch.from_numpy(np.asarray(self._codes_host[hit_idx])),
                    torch.zeros(c0, dtype=torch.int64),
                    torch.arange(c0)).numpy()
                order = np.lexsort((hit_idx, dv))
                pieces.append((np.full(c0, gid, np.int32), hit_idx[order],
                               dv[order]))
                continue
            ids = sel[start:end]
            groups.append((ids, eff[ids]))
            pieces.append(None)
        done = zip(groups, self._compactd_groups(q_padded, q_emb, groups))
        for i, piece in enumerate(pieces):
            if piece is None:
                (ids, _), (rows, idx, dv, got) = next(done)
                if not np.array_equal(got, counts[ids]):
                    raise RuntimeError("compaction hit counts disagree with "
                                       "the kstats hit counts")
                pieces[i] = (rows, idx, dv)
        e = np.empty(0, np.int32)
        # groups cover ascending disjoint row ranges, each sorted by
        # (row, distance, index): the concatenation is in emission order
        return (counts.astype(np.int32),
                *(np.concatenate([p[k] for p in pieces]) if pieces else e
                  for k in range(3)))

    def _host_enumerate_row(self, q_row: np.ndarray, thresh: int) -> np.ndarray:
        """All window indices with distance <= thresh for ONE query row,
        ascending, in chunks so a memmap db streams through a bounded
        working set."""
        if thresh < 0:
            return np.empty(0, np.int32)
        L = self.seq_len
        q = q_row[:L]
        out = []
        step = max(1, min(1 << 20, HOST_STEP_BYTES // L))
        for s in range(0, self.n_windows, step):
            d = np.asarray(self._codes_host[s:s + step])[:, :L]
            dist = L - (q == d).sum(axis=1)
            hit = np.nonzero(dist <= thresh)[0].astype(np.int32)
            out.append(hit + np.int32(s))
        return np.concatenate(out) if out else np.empty(0, np.int32)

