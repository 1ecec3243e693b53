"""Nucleotide alphabet: byte -> 5-channel one-hot classes.

Semantics pinned to the reference LUT (reference lib.rs:167-196 ``create_lut``):

- ``A/a`` -> A channel, ``C/c`` -> C, ``G/g`` -> G, ``T/t/U/u`` -> T
- every IUPAC degenerate code (``N W S M K R Y B D H V``, either case) and
  the gap character ``-`` collapse to the N channel
- anything else is invalid (the reference encodes it as 0 and panics,
  lib.rs:36-43)

The TPU-native canonical representation is the *channel index* 0..4
(A,C,G,T,N) stored as uint8, which expands to a one-hot int8 vector on
device. The reference's 5-bit one-hot codes (A=0b10000 .. N=0b00001,
lib.rs:171-180) are kept as a secondary representation for byte-exact
interop with reference postcard databases.
"""

from __future__ import annotations

import numpy as np

# Channel order: index into the one-hot axis. Chosen so that channel c has
# 5-bit code 1 << (4 - c), matching the reference's A=0b10000..N=0b00001.
CHANNELS = "ACGTN"
N_CHANNELS = 5

A, C, G, T, N = range(5)
INVALID = 255  # LUT sentinel for non-nucleotide bytes

# 5-bit one-hot codes used by the packed-u64 db format (reference lib.rs:171-180)
CODE_OF_CHANNEL = np.array([0b10000, 0b01000, 0b00100, 0b00010, 0b00001], dtype=np.uint8)


def _build_byte_lut() -> np.ndarray:
    """byte value -> channel index (0..4) or INVALID. Reference lib.rs:167-184."""
    lut = np.full(256, INVALID, dtype=np.uint8)
    for chars, chan in (
        ("Aa", A),
        ("Cc", C),
        ("Gg", G),
        ("TtUu", T),
        ("NWSMKRYBDHV-nwsmkrybdhv", N),
    ):
        for ch in chars:
            lut[ord(ch)] = chan
    return lut


BYTE_LUT = _build_byte_lut()

# 5-bit code -> channel index (32 entries); invalid codes -> INVALID
CODE_TO_CHANNEL = np.full(32, INVALID, dtype=np.uint8)
for _chan in range(N_CHANNELS):
    CODE_TO_CHANNEL[CODE_OF_CHANNEL[_chan]] = _chan

# channel index -> ASCII decode byte. All degenerates/gaps decode as 'N'
# (lossy normalization, reference lib.rs:113-131 get_as_string).
DECODE_BYTES = np.frombuffer(CHANNELS.encode(), dtype=np.uint8).copy()


class InvalidBaseError(ValueError):
    """A byte that is not a nucleotide / IUPAC code / gap.

    Message text matches the reference panic (lib.rs:38-42).
    """

    def __init__(self, byte: int, seqname: str, position: int):
        self.byte = byte
        self.seqname = seqname
        self.position = position
        super().__init__(
            f'Byte {byte} cannot be interpreted as nucleotide, in sequence '
            f'"{seqname}" at position {position}'
        )


def encode_bytes(seq: bytes | np.ndarray, identifier: str = "") -> np.ndarray:
    """Encode raw sequence bytes to channel indices (uint8 [L]).

    Raises InvalidBaseError with the reference's message on a bad byte
    (reference lib.rs:33-43 SeqEncodingLength::from_bytes error path).
    """
    raw = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    chans = BYTE_LUT[raw]
    bad = np.nonzero(chans == INVALID)[0]
    if bad.size:
        pos = int(bad[0])
        raise InvalidBaseError(int(raw[pos]), identifier, pos)
    return chans


def decode_channels(chans: np.ndarray) -> str:
    """Channel indices -> ASCII string (A/C/G/T/N).

    Mirrors reference get_as_string (lib.rs:113-134): any code that is not
    one of the five one-hot values panics; here that corresponds to a
    channel index outside 0..4.
    """
    if chans.size and int(chans.max(initial=0)) >= N_CHANNELS:
        bad = int(chans[chans >= N_CHANNELS][0])
        raise ValueError(f"Invalid character in query sequence: {bad}")
    return DECODE_BYTES[chans].tobytes().decode("ascii")
