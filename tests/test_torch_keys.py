"""ops/keys.py, the numpy key and shape helpers, equals the originals in
smafa_tpu.ops.distance over a grid of window lengths, db spans and
batch sizes."""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu.ops import distance as D0
from smafa_tpu_torch.ops import keys as K


def test_sentinels_equal():
    assert K.BIG == D0.BIG and K.BIG.dtype == D0.BIG.dtype


@pytest.mark.parametrize("seq_len", [1, 3, 6, 13, 60, 100, 127, 150, 1000,
                                     2**20, 2**26])
def test_packing_shift_equal(seq_len):
    for wp in [1, 2, 3, 64, 1000, 1 << 16, (1 << 20) + 37, 1 << 24,
               10_000_000, 1 << 28]:
        assert K.packing_shift(seq_len, wp) == D0.packing_shift(seq_len, wp)


@pytest.mark.parametrize("shift", [1, 6, 10, 20, 24])
def test_unpack_key_equal(shift):
    rng = np.random.default_rng(shift)
    dist = rng.integers(0, (2**31 - 1) >> shift, 500)
    idx = rng.integers(0, 1 << shift, 500)
    keys = ((dist << shift) | idx).astype(np.int32)
    keys[::7] = np.int32(2**31 - 1)  # empty rows
    for got, want in zip(K.unpack_key(keys, shift), D0.unpack_key(keys, shift)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("minimum", [1, 16, 128, 1024])
def test_bucket_equal(minimum):
    for n in list(range(0, 70)) + [1000, 4096, 4097, 65535, 65536, 65537]:
        assert K.bucket(n, minimum) == D0.bucket(n, minimum)


# pad_batch's cases: batch rows x (multiple, minimum). The tests are in
# test_torch_keys_pad.py (up to 16 rows) and test_torch_keys_pad_large.py.
PAD_ROWS = [0, 1, 15, 16, 17, 100, 2048, 3000]
PAD_SHAPES = [(1, 16), (4, 16), (3, 8)]


def check_pad_batch(n, multiple, minimum):
    rng = np.random.default_rng(n)
    q = rng.integers(0, 5, (n, 7), dtype=np.uint8)
    g, gn, gb = K.pad_batch(q, multiple, minimum)
    w, wn, wb = D0.pad_batch(q, multiple, minimum)
    assert (gn, gb) == (wn, wb)
    np.testing.assert_array_equal(g, w)
