"""Byte-exact reader/writer for the reference smafa v2 database format.

The reference serializes its ``WindowSet`` struct with the postcard crate
(reference lib.rs:160-162, 206-218). Postcard encodes:

- unsigned integers (u32/u64/usize) as unsigned-LEB128 varints,
- ``Vec<T>`` as varint(length) then elements,
- ``Option<T>`` as one tag byte (0x00 None / 0x01 Some) then the value.

So a db file is::

    varint(version=2)
    varint(num_windows)
    for each window: varint(num_words) then varint(word) * num_words
    option tag + varint(length)          # len: Option<NonZeroUsize>

Verified against the checked-in fixtures (reference
tests/data/random_3_2.fna.smafadb = ``02 02 01 c8 10 01 90 21 01 03``).

The version can be "peeked" by parsing the first varint, mirroring
``postcard::from_bytes(&buffer[0..4])`` (lib.rs:214). A version other than
2 raises UnsupportedDbVersion with the reference's panic text
(lib.rs:215-217).

The window-stream varint coding has two implementations with identical
bytes: a native C++ single-pass codec (smafa_tpu/native/fastx.cpp —
10M-row dbs encode in ~4s / decode in ~4s, memory-bound) used whenever
the extension is built, and a vectorized-numpy fallback that is fine to
~1M rows but goes superlinear beyond (temporary-array pressure).
"""

from __future__ import annotations

import numpy as np

from smafa_tpu_torch.core.windowset import WindowSet

CURRENT_DB_VERSION = 2  # reference lib.rs:18


class UnsupportedDbVersion(ValueError):
    def __init__(self, version: int):
        self.version = version
        super().__init__(
            f"Unsupported db file version: {version}. This version of smafa only "
            f"works with version {CURRENT_DB_VERSION} databases. The last version "
            f"to support version 1 databases was v0.7.1."
        )


class PostcardError(ValueError):
    pass


# ---------------------------------------------------------------------------
# scalar varint helpers


def read_varint(buf: bytes | np.ndarray, pos: int) -> tuple[int, int]:
    """Parse one unsigned-LEB128 varint at ``pos``; returns (value, new_pos)."""
    value = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise PostcardError("Hit the end of buffer, expected more data")
        byte = int(buf[pos])
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7
        if shift >= 70:
            # Same 10-byte limit as the vectorized decoder (lengths > 10)
            # and the native codec: a u64 varint is at most 10 bytes, so a
            # continuation bit on the 10th byte is overlong.
            raise PostcardError("Found a varint that didn't terminate")


def write_varint(value: int, out: bytearray) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def peek_version(buf: bytes) -> int:
    """Mirror of the reference's version peek on buffer[0..4] (lib.rs:214)."""
    if len(buf) == 0:
        raise PostcardError("Hit the end of buffer, expected more data")
    value, pos = read_varint(buf[:4], 0)
    return value


# ---------------------------------------------------------------------------
# vectorized varint coding for uint64 arrays


def _encode_varints(values: np.ndarray) -> np.ndarray:
    """uint64 [N] -> concatenated LEB128 byte stream (uint8 array)."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.uint8)
    # Each u64 takes at most 10 varint bytes.
    groups = np.empty((n, 10), dtype=np.uint8)
    v = values.copy()
    for k in range(10):
        groups[:, k] = (v & np.uint64(0x7F)).astype(np.uint8)
        v >>= np.uint64(7)
    # number of bytes needed per value
    nbytes = np.maximum(
        1,
        np.ceil((64 - _clz64(values)) / 7.0).astype(np.int64),
    )
    # set continuation bits on all but the last byte of each group
    k_idx = np.arange(10, dtype=np.int64)
    cont = k_idx[None, :] < (nbytes[:, None] - 1)
    groups = np.where(cont, groups | 0x80, groups)
    keep = k_idx[None, :] < nbytes[:, None]
    return groups[keep]


def _clz64(values: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint64s (vectorized)."""
    out = np.full(values.shape, 64, dtype=np.int64)
    v = values.copy()
    bits = np.zeros(values.shape, dtype=np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        mask = v >= (np.uint64(1) << np.uint64(shift))
        bits = np.where(mask, bits + shift, bits)
        v = np.where(mask, v >> np.uint64(shift), v)
    nonzero = values != 0
    out[nonzero] = 63 - bits[nonzero]
    return out


def _decode_varints(data: np.ndarray, count: int, pos: int) -> tuple[np.ndarray, int]:
    """Decode ``count`` varints from ``data`` starting at ``pos`` (vectorized).

    Returns (uint64 [count], new_pos).
    """
    if count == 0:
        return np.empty(0, dtype=np.uint64), pos
    tail = data[pos:]
    is_last = tail < 0x80
    # positions (within tail) of the final byte of each varint
    ends = np.nonzero(is_last)[0]
    if ends.size < count:
        # An unterminated tail of >= 10 continuation bytes can never
        # terminate validly — classify it as overlong, exactly like the
        # scalar and native decoders (10-byte u64 varint limit).
        last_end = int(ends[-1]) if ends.size else -1
        if tail.shape[0] - (last_end + 1) >= 10:
            raise PostcardError("Found a varint that didn't terminate")
        raise PostcardError("Hit the end of buffer, expected more data")
    ends = ends[:count]
    starts = np.empty(count, dtype=np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lengths = ends - starts + 1
    if int(lengths.max()) > 10:
        raise PostcardError("Found a varint that didn't terminate")
    values = np.zeros(count, dtype=np.uint64)
    maxlen = int(lengths.max())
    for k in range(maxlen):
        sel = lengths > k
        byte = tail[starts[sel] + k].astype(np.uint64)
        values[sel] |= (byte & np.uint64(0x7F)) << np.uint64(7 * k)
    return values, pos + int(ends[-1]) + 1


# ---------------------------------------------------------------------------
# WindowSet (de)serialization


def _native_lib():
    from smafa_tpu_torch.native import load

    return load()


def dumps(ws: WindowSet) -> bytes:
    """Serialize a WindowSet to postcard v2 bytes, byte-identical to the
    reference writer (lib.rs:160-162).

    The window stream is encoded by the native C++ codec when built (the
    numpy path goes superlinear past ~1M rows); both paths are
    byte-identical and differentially tested.
    """
    out = bytearray()
    write_varint(ws.version, out)
    n = len(ws)
    write_varint(n, out)
    if n:
        from smafa_tpu_torch.core.encoding import words_per_seq

        wps = words_per_seq(ws.length)
        lib = _native_lib()
        if lib is not None:
            import ctypes

            codes = np.ascontiguousarray(ws.codes, dtype=np.uint8)
            buf = np.empty(n * (10 * wps + 10), dtype=np.uint8)
            written = lib.postcard_encode_codes(
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n, ws.length,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            tail = bytearray([0x01])  # Some
            write_varint(ws.length, tail)
            # One join: bytearray.extend + bytes() would copy the ~45B/row
            # body two extra times (tens of seconds at 10M rows).
            return b"".join([bytes(out), buf[:written].tobytes(), bytes(tail)])
        words = ws.packed_words()  # [n, wps]
        # stream: per window, varint(wps) then wps varints. Encode all words
        # vectorized, then interleave the per-window length prefixes.
        payload = _encode_varints(words.reshape(-1))
        # byte length of each encoded word
        word_lens = np.maximum(1, np.ceil((64 - _clz64(words.reshape(-1))) / 7.0)).astype(np.int64)
        per_window = word_lens.reshape(n, wps).sum(axis=1)
        prefix = bytearray()
        write_varint(wps, prefix)
        p = len(prefix)
        total = int(per_window.sum())
        body = np.empty(n * p + total, dtype=np.uint8)
        row_of_byte = np.repeat(np.arange(n, dtype=np.int64), per_window)
        body[np.arange(total, dtype=np.int64) + (row_of_byte + 1) * p] = payload
        prefix_starts = (
            np.arange(n, dtype=np.int64) * p
            + np.concatenate([[0], np.cumsum(per_window)[:-1]])
        )
        for k in range(p):
            body[prefix_starts + k] = prefix[k]
        out.extend(body.tobytes())
        out.append(0x01)  # Some
        write_varint(ws.length, out)
    else:
        if ws.length is None:
            out.append(0x00)  # None
        else:
            out.append(0x01)
            write_varint(ws.length, out)
    return bytes(out)


def loads(buf: bytes) -> WindowSet:
    """Deserialize postcard v2 bytes to a WindowSet.

    Raises UnsupportedDbVersion for version != 2, mirroring the reference
    version gate (lib.rs:214-217).
    """
    data = np.frombuffer(buf, dtype=np.uint8)
    version = peek_version(buf)
    if version != CURRENT_DB_VERSION:
        raise UnsupportedDbVersion(version)
    _, pos = read_varint(data, 0)
    n, pos = read_varint(data, pos)
    if n == 0:
        tag, pos = _read_option_tag(data, pos)
        length = None
        if tag:
            length, pos = read_varint(data, pos)
        ws = WindowSet(version)
        ws.length = length
        return ws
    # Window word counts are uniform in any db written by makedb (equal
    # lengths enforced, lib.rs:91-111), so the stream is a flat run of
    # n*(wps+1) varints: decode via the native C++ codec when built,
    # else vectorized numpy.
    wps, _ = read_varint(data, pos)
    lib = _native_lib()
    if lib is not None:
        import ctypes

        words = np.empty((n, wps), dtype=np.uint64)
        consumed = lib.postcard_decode_windows(
            data[pos:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data) - pos, n, wps,
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        if consumed == -4:
            raise PostcardError("Found a varint that didn't terminate")
        if consumed == -3:
            raise PostcardError("Hit the end of buffer, expected more data")
        if consumed < 0:
            raise PostcardError("Non-uniform window word counts in db")
        pos += consumed
    else:
        flat, pos = _decode_varints(data, n * (wps + 1), pos)
        flat = flat.reshape(n, wps + 1)
        if not np.all(flat[:, 0] == wps):
            raise PostcardError("Non-uniform window word counts in db")
        words = np.ascontiguousarray(flat[:, 1:])
    tag, pos = _read_option_tag(data, pos)
    length = None
    if tag:
        length, pos = read_varint(data, pos)
    from smafa_tpu_torch.core.encoding import words_per_seq

    if lib is not None and length and wps == words_per_seq(length):
        import ctypes

        codes = np.empty((n, length), dtype=np.uint8)
        bad = ctypes.c_int32()
        rc = lib.unpack_words_codes(
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n, wps, length,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(bad),
        )
        if rc == -2:
            raise ValueError(f"Invalid character in query sequence: {bad.value}")
        return WindowSet.from_matrix(codes, version)
    return WindowSet.from_packed(words, length, version)


def _read_option_tag(data: np.ndarray, pos: int) -> tuple[int, int]:
    if pos >= len(data):
        raise PostcardError("Hit the end of buffer, expected more data")
    tag = int(data[pos])
    if tag not in (0, 1):
        raise PostcardError(f"Bad Option tag {tag}")
    return tag, pos + 1
