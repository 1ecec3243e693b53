"""The port's host formats equal smafa_tpu's: FASTX batches of 8192 on
tests/data (the other batch sizes are in test_torch_host_batches.py),
the packed channel words, and byte-identical postcard dumps."""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu.core import encoding as E0
from smafa_tpu.io import postcard as P0
from smafa_tpu_torch.core import encoding as E1
from smafa_tpu_torch.io import postcard as P1
from test_torch_host import BATCH_SIZES, FASTX, check_encoded_batches, windowsets


@pytest.mark.parametrize("fname", FASTX)
@pytest.mark.parametrize("batch_size", BATCH_SIZES[2:])
def test_encoded_batches_equal(fname, batch_size):
    check_encoded_batches(fname, batch_size)


@pytest.mark.parametrize("length", [1, 3, 11, 12, 13, 60, 150])
def test_pack_unpack_equal(length):
    rng = np.random.default_rng(length)
    chans = rng.integers(0, 5, (37, length), dtype=np.uint8)
    w0 = E0.pack_channels(chans)
    np.testing.assert_array_equal(E1.pack_channels(chans), w0)
    np.testing.assert_array_equal(E1.unpack_words(w0, length),
                                  E0.unpack_words(w0, length))


@pytest.mark.parametrize("n,length", [(0, 3), (1, 1), (5, 3), (300, 60),
                                      (1000, 13), (64, 150)])
def test_postcard_dumps_byte_identical(n, length):
    ws0, ws1 = windowsets(np.random.default_rng(n), n, length)
    blob = P0.dumps(ws0)
    assert P1.dumps(ws1) == blob
    back = P1.loads(blob)
    np.testing.assert_array_equal(back.codes, ws0.codes)
    assert back.length == (length if n else None)
