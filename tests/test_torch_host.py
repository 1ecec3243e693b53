"""The port's host layers (copied from smafa_tpu because importing any
smafa_tpu module loads jax) stay equal to the originals: same source
apart from the package name, same values on tests/data, and
byte-identical db files. The FASTX batch, format and db cases are in
test_torch_host_batches.py, test_torch_host_formats.py and
test_torch_host_dbs.py, which take their helpers from here."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from smafa_tpu.core import alphabet as A0, windowset as W0
from smafa_tpu.io import fastx as F0
from smafa_tpu_torch.core import alphabet as A1, windowset as W1
from smafa_tpu_torch.io import fastx as F1

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


# Shared with the tests split off this file: test_torch_host_batches.py
# and test_torch_host_formats.py (encoded batches), test_torch_host_dbs.py.
BATCH_SIZES = [1, 2, 8192]


def check_encoded_batches(fname, batch_size):
    want = list(F0.read_encoded_batches(DATA / fname, batch_size))
    got = list(F1.read_encoded_batches(DATA / fname, batch_size))
    assert len(got) == len(want)
    for (gi, gr, gc), (wi, wr, wc) in zip(got, want):
        assert list(gi) == list(wi) and list(gr) == list(wr)
        np.testing.assert_array_equal(gc, wc)


def windowsets(rng, n, length):
    codes = rng.integers(0, 5, (n, length), dtype=np.uint8)
    return (W0.WindowSet.from_matrix(codes, 2),
            W1.WindowSet.from_matrix(codes, 2))


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
