"""ops/keys.py's pad_batch equals smafa_tpu.ops.distance.pad_batch on
batches of 17 to 3000 rows (the cases of test_torch_keys.py)."""

from __future__ import annotations

import pytest

from test_torch_keys import PAD_ROWS, PAD_SHAPES, check_pad_batch


@pytest.mark.parametrize("n", PAD_ROWS[4:])
@pytest.mark.parametrize("multiple,minimum", PAD_SHAPES)
def test_pad_batch_equal(n, multiple, minimum):
    check_pad_batch(n, multiple, minimum)
