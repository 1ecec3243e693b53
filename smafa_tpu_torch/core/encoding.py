"""Packed-u64 sequence encoding, byte-compatible with the reference db format.

The reference packs 12 bases per u64, base *i* of a chunk occupying bits
``5*i .. 5*i+4`` with bits 60-63 zero (reference lib.rs:29-52
``SeqEncodingLength::from_bytes``). The TPU framework keeps channel-index
arrays as its canonical form; the packed form is used for

- byte-exact (de)serialization of reference postcard v2 databases,
- exact-duplicate detection keys in ``cluster`` (reference cluster.rs:46-48
  hashes the packed ``Vec<u64>``).

All transforms are vectorized numpy over whole batches.
"""

from __future__ import annotations

import numpy as np

from smafa_tpu_torch.core.alphabet import CODE_OF_CHANNEL, CODE_TO_CHANNEL, INVALID

BASES_PER_WORD = 12  # reference lib.rs:31
_SHIFTS = (np.arange(BASES_PER_WORD, dtype=np.uint64) * np.uint64(5))


def words_per_seq(length: int) -> int:
    return (length + BASES_PER_WORD - 1) // BASES_PER_WORD


def pack_channels(chans: np.ndarray) -> np.ndarray:
    """Channel indices uint8 [L] (or [B, L]) -> packed uint64 [W] (or [B, W]).

    Trailing chunk is zero-padded, exactly like the reference's final
    partial chunk fold (lib.rs:32-46).
    """
    chans = np.asarray(chans, dtype=np.uint8)
    length = chans.shape[-1]
    nwords = words_per_seq(length)
    pad = nwords * BASES_PER_WORD - length
    codes = CODE_OF_CHANNEL[chans].astype(np.uint64)
    if pad:
        # pad with the 0 CODE (empty 5-bit group), not channel 0 ('A')
        pad_spec = [(0, 0)] * (codes.ndim - 1) + [(0, pad)]
        codes = np.pad(codes, pad_spec)
    codes = codes.reshape(codes.shape[:-1] + (nwords, BASES_PER_WORD))
    return (codes << _SHIFTS).sum(axis=-1, dtype=np.uint64)


def unpack_words(words: np.ndarray, length: int) -> np.ndarray:
    """Packed uint64 [..., W] -> channel indices uint8 [..., length].

    Raises on any 5-bit group that is not one of the five one-hot codes,
    mirroring the reference decode panic (lib.rs:126-129
    "Invalid character in query sequence: {b}").
    """
    words = np.asarray(words, dtype=np.uint64)
    if words.shape[-1] * BASES_PER_WORD < length:
        raise ValueError(
            f"Packed stream has {words.shape[-1]} words per window — too few "
            f"for sequences of length {length}"
        )
    groups = (words[..., :, None] >> _SHIFTS) & np.uint64(31)
    groups = groups.reshape(words.shape[:-1] + (-1,))[..., :length].astype(np.uint8)
    chans = CODE_TO_CHANNEL[groups]
    if chans.size and int(chans.max(initial=0)) == INVALID:
        bad = int(groups[chans == INVALID].ravel()[0])
        raise ValueError(f"Invalid character in query sequence: {bad}")
    return chans


def dedup_key(chans: np.ndarray) -> bytes:
    """Hashable exact-duplicate key for one sequence.

    The reference dedups on the packed encoding (cluster.rs:46-48), so
    sequences whose raw bytes differ but encode identically (e.g. 'R' vs
    'N' vs '-') are duplicates of each other. Channel indices are a
    bijection of the packed form for valid sequences, so hashing them is
    equivalent.
    """
    return np.ascontiguousarray(chans, dtype=np.uint8).tobytes()
