"""The port's FASTX reader yields the batches smafa_tpu's does on
tests/data, at batch sizes 1 and 2 (the cases of test_torch_host.py; 8192
is in test_torch_host_formats.py)."""

from __future__ import annotations

import pytest

from test_torch_host import BATCH_SIZES, FASTX, check_encoded_batches


@pytest.mark.parametrize("fname", FASTX)
@pytest.mark.parametrize("batch_size", BATCH_SIZES[:2])
def test_encoded_batches_equal(fname, batch_size):
    check_encoded_batches(fname, batch_size)
