"""WindowSet: the database / centroid container.

TPU-native equivalent of the reference's ``WindowSet`` struct
(reference lib.rs:54-135): a versioned list of equal-length encoded
sequences. Here the storage is a dense uint8 channel-index matrix
``[num_windows, length]`` — the layout that expands directly to the
one-hot int8 tensor consumed by the device distance kernel — grown
amortized-doubling for streaming ``makedb``/``cluster`` ingest.
"""

from __future__ import annotations

import numpy as np

from smafa_tpu_torch.core import alphabet
from smafa_tpu_torch.core.encoding import pack_channels, unpack_words


class LengthMismatchError(ValueError):
    pass


class WindowSet:
    def __init__(self, version: int = 0, length: int | None = None):
        self.version = version
        self.length = length  # None until the first sequence is pushed
        self._buf: np.ndarray | None = None
        self._n = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def from_matrix(cls, codes: np.ndarray, version: int) -> "WindowSet":
        ws = cls(version)
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        if codes.size:
            ws.length = int(codes.shape[1])
            ws._buf = codes
            ws._n = int(codes.shape[0])
        return ws

    def push(self, chans: np.ndarray) -> None:
        """Append one encoded sequence, enforcing uniform length.

        Error texts match the reference push_encoding panics
        (lib.rs:91-111).
        """
        length = int(chans.shape[-1])
        if self.length is None:
            if length == 0:
                raise LengthMismatchError("Cannot add empty sequence to WindowSet")
            self.length = length
        elif length != self.length:
            raise LengthMismatchError(
                f"WindowSet seq length is {self.length}, got a new sequence of length {length}"
            )
        if self._buf is None or self._n == self._buf.shape[0]:
            cap = max(16, (0 if self._buf is None else self._buf.shape[0]) * 2)
            new = np.empty((cap, self.length), dtype=np.uint8)
            if self._n:
                new[: self._n] = self._buf[: self._n]
            self._buf = new
        self._buf[self._n] = chans
        self._n += 1

    def push_batch(self, chans: np.ndarray) -> None:
        """Append a [B, L] batch with one bulk copy (same error contract
        as push: empty-sequence and length-mismatch texts from
        lib.rs:91-111)."""
        k = int(chans.shape[0])
        if k == 0:
            return
        if k == 1 or self.length is None:
            # Route the first row through push for the exact first-sequence
            # error behavior, then bulk-append the rest.
            self.push(chans[0])
            chans = chans[1:]
            k -= 1
            if k == 0:
                return
        length = int(chans.shape[-1])
        if length != self.length:
            raise LengthMismatchError(
                f"WindowSet seq length is {self.length}, got a new sequence of length {length}"
            )
        need = self._n + k
        if self._buf is None or need > self._buf.shape[0]:
            cap = max(16, self._buf.shape[0] if self._buf is not None else 16)
            while cap < need:
                cap *= 2
            new = np.empty((cap, self.length), dtype=np.uint8)
            if self._n:
                new[: self._n] = self._buf[: self._n]
            self._buf = new
        self._buf[self._n : need] = chans
        self._n = need

    # -- access ------------------------------------------------------------

    def __len__(self) -> int:
        return self._n

    @property
    def codes(self) -> np.ndarray:
        """uint8 [num_windows, length] channel-index matrix (zero-copy view)."""
        if self._buf is None:
            return np.empty((0, 0 if self.length is None else self.length), dtype=np.uint8)
        return self._buf[: self._n]

    def check_query_length(self, qlen: int) -> None:
        """Reference get_distances length guard (lib.rs:71-78)."""
        if self.length is not None and qlen != self.length:
            raise LengthMismatchError(
                f"Cannot compute distances between seq of length {qlen} "
                f"and windows of lengths {self.length}"
            )

    def get_as_string(self, index: int) -> str:
        """Decode entry ``index`` back to ASCII (degenerates/gaps -> 'N'),
        mirroring reference get_as_string (lib.rs:113-134)."""
        return alphabet.decode_channels(self.codes[index])

    def decoded_strings(self) -> list[str]:
        """Decode every window at once (vectorized)."""
        if self._n == 0:
            return []
        mat = alphabet.DECODE_BYTES[self.codes]
        flat = mat.tobytes().decode("ascii")
        step = self.length
        return [flat[i * step : (i + 1) * step] for i in range(self._n)]

    # -- packed-u64 interop (reference on-disk form) ------------------------

    def packed_words(self) -> np.ndarray:
        """uint64 [num_windows, words_per_seq] packed encodings."""
        if self._n == 0:
            return np.empty((0, 0), dtype=np.uint64)
        return pack_channels(self.codes)

    @classmethod
    def from_packed(cls, words: np.ndarray, length: int | None, version: int) -> "WindowSet":
        if words.shape[0] == 0 or length is None:
            ws = cls(version)
            ws.length = length
            return ws
        return cls.from_matrix(unpack_words(words, length), version)
