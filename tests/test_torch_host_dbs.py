"""The port's db files equal smafa_tpu's: byte-identical native saves,
and every db of tests/data loads to the same windows (or the same
unsupported-version error)."""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu.io import native_format as N0, postcard as P0
from smafa_tpu_torch.io import db as DB1, native_format as N1
from smafa_tpu_torch.io import postcard as P1
from test_torch_host import DATA, DBS, windowsets


@pytest.mark.parametrize("n,length", [(0, 3), (5, 3), (300, 60), (64, 150)])
def test_native_save_byte_identical(tmp_path, n, length):
    ws0, ws1 = windowsets(np.random.default_rng(n), n, length)
    N0.save(ws0, tmp_path / "a")
    N1.save(ws1, tmp_path / "b")
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    np.testing.assert_array_equal(N1.load(tmp_path / "a").codes, ws0.codes)


@pytest.mark.parametrize("fname", DBS)
def test_load_db_equal(fname):
    from smafa_tpu.io.db import load_db as load0

    try:
        want = load0(DATA / fname)
    except P0.UnsupportedDbVersion as exc:
        with pytest.raises(P1.UnsupportedDbVersion) as ei:
            DB1.load_db(DATA / fname)
        assert str(ei.value) == str(exc)
        return
    got = DB1.load_db(DATA / fname)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert (got.length, got.version) == (want.length, want.version)
    assert [got.get_as_string(i) for i in range(len(got))] == \
        [want.get_as_string(i) for i in range(len(want))]
