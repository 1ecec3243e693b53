"""The port's host layers (copied from smafa_tpu because importing any
smafa_tpu module loads jax) stay equal to the originals: same source
apart from the package name, same values on tests/data, and
byte-identical db files."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from smafa_tpu.core import alphabet as A0, encoding as E0, windowset as W0
from smafa_tpu.io import fastx as F0, native_format as N0, postcard as P0
from smafa_tpu_torch.core import alphabet as A1, encoding as E1, windowset as W1
from smafa_tpu_torch.io import db as DB1, fastx as F1, native_format as N1
from smafa_tpu_torch.io import postcard as P1

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
FASTX = sorted(p.name for p in DATA.iterdir()
               if p.suffix in (".fna", ".fa", ".gz"))
DBS = sorted(p.name for p in DATA.glob("*.smafadb"))


@pytest.mark.parametrize("module", [
    "core/alphabet.py", "core/encoding.py", "core/windowset.py",
    "io/native_format.py", "io/db.py",
])
def test_copied_module_source_pinned(module):
    """Verbatim copies: only the package name differs."""
    orig = (ROOT / "smafa_tpu" / module).read_text()
    port = (ROOT / "smafa_tpu_torch" / module).read_text()
    assert port.replace("smafa_tpu_torch.", "smafa_tpu.") == orig


@pytest.mark.parametrize("name", [
    "BYTE_LUT", "CODE_TO_CHANNEL", "CODE_OF_CHANNEL", "DECODE_BYTES",
])
def test_alphabet_tables_equal(name):
    np.testing.assert_array_equal(getattr(A1, name), getattr(A0, name))


@pytest.mark.parametrize("fname", FASTX)
def test_records_and_encoding_equal(fname):
    want = list(F0.read_records(DATA / fname))
    got = list(F1.read_records(DATA / fname))
    assert got == want
    for rid, seq in got:
        np.testing.assert_array_equal(A1.encode_bytes(seq, rid),
                                      A0.encode_bytes(seq, rid))


@pytest.mark.parametrize("fname", FASTX)
@pytest.mark.parametrize("batch_size", [1, 2, 8192])
def test_encoded_batches_equal(fname, batch_size):
    want = list(F0.read_encoded_batches(DATA / fname, batch_size))
    got = list(F1.read_encoded_batches(DATA / fname, batch_size))
    assert len(got) == len(want)
    for (gi, gr, gc), (wi, wr, wc) in zip(got, want):
        assert list(gi) == list(wi) and list(gr) == list(wr)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("body,err", [
    (b">a\nACXT\n", "Byte 88 cannot be interpreted as nucleotide"),
    (b"", "Empty or invalid FASTX file"),
    (b"ACGT\n", "bad leading byte"),
])
def test_fastx_errors_equal(tmp_path, body, err):
    p = tmp_path / "bad.fna"
    p.write_bytes(body)
    msgs = []
    for mod in (F0, F1):
        with pytest.raises(ValueError) as ei:
            list(mod.read_encoded_batches(p, 4))
        msgs.append(str(ei.value))
    assert err in msgs[1]
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("length", [1, 3, 11, 12, 13, 60, 150])
def test_pack_unpack_equal(length):
    rng = np.random.default_rng(length)
    chans = rng.integers(0, 5, (37, length), dtype=np.uint8)
    w0 = E0.pack_channels(chans)
    np.testing.assert_array_equal(E1.pack_channels(chans), w0)
    np.testing.assert_array_equal(E1.unpack_words(w0, length),
                                  E0.unpack_words(w0, length))


def _windowsets(rng, n, length):
    codes = rng.integers(0, 5, (n, length), dtype=np.uint8)
    return (W0.WindowSet.from_matrix(codes, 2),
            W1.WindowSet.from_matrix(codes, 2))


@pytest.mark.parametrize("n,length", [(0, 3), (1, 1), (5, 3), (300, 60),
                                      (1000, 13), (64, 150)])
def test_postcard_dumps_byte_identical(n, length):
    ws0, ws1 = _windowsets(np.random.default_rng(n), n, length)
    blob = P0.dumps(ws0)
    assert P1.dumps(ws1) == blob
    back = P1.loads(blob)
    np.testing.assert_array_equal(back.codes, ws0.codes)
    assert back.length == (length if n else None)


@pytest.mark.parametrize("n,length", [(0, 3), (5, 3), (300, 60), (64, 150)])
def test_native_save_byte_identical(tmp_path, n, length):
    ws0, ws1 = _windowsets(np.random.default_rng(n), n, length)
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


def test_windowset_errors_equal():
    msgs = []
    for W in (W0, W1):
        ws = W.WindowSet(2)
        ws.push_batch(np.zeros((2, 3), np.uint8))
        with pytest.raises(ValueError) as e1:
            ws.push(np.zeros(4, np.uint8))
        with pytest.raises(ValueError) as e2:
            ws.check_query_length(6)
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]
