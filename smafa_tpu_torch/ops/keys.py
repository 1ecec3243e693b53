"""Packed-key, batch-shape and K-mode search constants, pure numpy.

Copies of the numpy helpers in ``smafa_tpu.ops.distance`` (which imports
jax, so the port cannot import them); tests pin them equal to the
originals.

A packed key ``(dist << shift) | subject_index`` orders pairs exactly as
the reference's ``(distance, subject_index)`` ascending sort
(reference lib.rs:243-250), so one integer ``min`` yields the minimum
distance and its lowest index (the tie rule of lib.rs:306-313).
"""

from __future__ import annotations

import math

import numpy as np

BIG = np.int32(2**30)  # sentinel distance for padded / masked-out windows
BIG_KEY = 2**31 - 1    # empty-row key
KSTATS_PROBES = 4      # per-row thresholds probed per K-mode cutoff pass
# The K-mode histogram program serves only windows shorter than this
# (``SMAFA_TPU_KMODE_HIST=1``); longer ones keep the kstats search.
HIST_MAX = 1024


def kstats_steps(seq_len: int) -> int:
    """Passes of the K-mode cutoff search: each pass cuts the candidate
    range [lo, hi] to <= (hi - lo) // KSTATS_PROBES with KSTATS_PROBES - 1
    interior probes, so at 60 bp ranges shrink 60 -> 15 -> 3 -> 0 in 3
    passes."""
    steps, n = 0, seq_len
    while n > 0:
        n //= KSTATS_PROBES
        steps += 1
    return max(1, steps)


def packing_shift(seq_len: int, wp: int) -> int | None:
    """Bits for (dist << shift) | index packing; None if > 31 bits total.
    The distance field budgets seq_len + 2 values (real distances plus
    the padding sentinel seq_len + 1)."""
    bits_idx = max(1, math.ceil(math.log2(max(2, wp))))
    bits_dist = max(1, math.ceil(math.log2(seq_len + 2)))
    if bits_idx + bits_dist > 31:
        return None
    return bits_idx


def packing_span(seq_len: int) -> int | None:
    """Port-only (no counterpart in ``smafa_tpu``): the widest span of
    db rows, a multiple of 64 (the kernels' tile), whose local keys pack
    into 31 bits, 2^(31 - ceil(log2(L + 2))) rows; None when not even 64
    rows pack (windows of 2^25 - 1 bp or more). Found through
    ``packing_shift``, so it follows that one packing rule."""
    for bits in range(31, 5, -1):
        if packing_shift(seq_len, 1 << bits) is not None:
            return 1 << bits
    return None


def wide_route(seq_len: int) -> bool:
    """Port-only: windows so long that not even one 64-row tile packs a
    31-bit key (2^25 - 1 bp or more), which the port serves from exact
    int32 distance blocks (``parallel.wide``, and the cluster's wide
    centroid scan) where ``smafa_tpu`` runs its top-M sort-merge and
    ``min_scan``'s pair carry. Found through ``packing_span``, so it
    follows that one packing rule."""
    return packing_span(seq_len) is None


def unpack_key(key: np.ndarray, shift: int) -> tuple[np.ndarray, np.ndarray]:
    """Packed keys -> (distance, index); BIG/int32-max for empty rows."""
    big = key == np.int32(BIG_KEY)
    dist = np.where(big, BIG, key >> shift).astype(np.int32)
    idx = np.where(big, np.int32(BIG_KEY), key & ((1 << shift) - 1)).astype(np.int32)
    return dist, idx


def bucket(n: int, minimum: int = 16) -> int:
    """Power-of-two size bucketing."""
    return max(minimum, 1 << math.ceil(math.log2(max(1, n))))


def pad_batch(
    q_codes: np.ndarray, multiple: int = 1, minimum: int = 16
) -> tuple[np.ndarray, int, int]:
    """Pad a query batch to a power-of-two bucket rounded up to
    ``multiple``. Returns (padded, nq, b); padded rows are zeros whose
    results callers trim with nq."""
    nq = q_codes.shape[0]
    b = ((bucket(nq, minimum) + multiple - 1) // multiple) * multiple
    if nq < b:
        q_codes = np.pad(q_codes, [(0, b - nq), (0, 0)])
    return q_codes, nq, b
