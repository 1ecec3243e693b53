"""The port's native FASTX ingest and postcard codec, mirroring
tests/test_native_ingest.py: the port's records, batches, errors and
db bytes equal smafa_tpu's, with the native library and under
SMAFA_TPU_NO_NATIVE=1 alike (the variable switches both packages, so
smafa_tpu's answer is taken first, natively)."""

import numpy as np
import pytest

from smafa_tpu.core.windowset import WindowSet as WS0
from smafa_tpu.io import fastx as F0, postcard as P0
from smafa_tpu_torch.core.alphabet import InvalidBaseError
from smafa_tpu_torch.core.windowset import WindowSet as WS1
from smafa_tpu_torch.io import fastx as F1, postcard as P1
from smafa_tpu_torch.native import load


def both_ways(monkeypatch, fn):
    """fn() with the native library, then under the opt-out."""
    native = fn()
    monkeypatch.setenv("SMAFA_TPU_NO_NATIVE", "1")
    try:
        return native, fn()
    finally:
        monkeypatch.delenv("SMAFA_TPU_NO_NATIVE")


def records(fx, path):
    return list(fx.read_records(path))


def batches(fx, path, batch_size):
    return [(ids, raws, codes.tolist())
            for ids, raws, codes in fx.read_encoded_batches(path, batch_size)]


def test_native_library_loads():
    assert load() is not None


@pytest.mark.parametrize(
    "name",
    ["subjects.fa", "random_3_2.fna", "degenerate.fna", "random_30_4.fq.gz"],
)
def test_native_matches_python_records(data_dir, name, monkeypatch):
    path = data_dir / name
    parsed = F1.parse_native(path)
    whole = [(parsed.record_id(i), parsed.raw_seq(i)) for i in range(parsed.n)]
    want = records(F0, path)
    native, python = both_ways(monkeypatch, lambda: records(F1, path))
    assert whole == native == python == want


@pytest.mark.parametrize("name", ["subjects.fa", "random_30_4.fq.gz"])
def test_native_matches_python_batches(data_dir, name, monkeypatch):
    want = batches(F0, data_dir / name, 3)
    native, python = both_ways(monkeypatch,
                               lambda: batches(F1, data_dir / name, 3))
    assert native == python == want


def test_native_uniform_batches(tmp_path):
    f = tmp_path / "u.fna"
    f.write_text("".join(f">s{i}\nACGTACGT\n" for i in range(10)))
    got = list(F1.read_encoded_batches(f, batch_size=4))
    assert [len(b[0]) for b in got] == [4, 4, 2]
    assert all(b[2].shape[1] == 8 for b in got)
    assert batches(F1, f, 4) == batches(F0, f, 4)


def test_native_invalid_base_error(tmp_path, monkeypatch):
    bad = tmp_path / "bad.fna"
    bad.write_text(">seq one\nACGTACGTXA\n")

    def error():
        with pytest.raises(InvalidBaseError) as e:
            list(F1.read_encoded_batches(bad, batch_size=16))
        return str(e.value)

    with pytest.raises(Exception) as e0:
        list(F0.read_encoded_batches(bad, batch_size=16))
    native, python = both_ways(monkeypatch, error)
    # Reference panic parameters (lib.rs:38-42): byte, full id, position.
    assert native == python == str(e0.value)
    assert "Byte 88" in native and '"seq one"' in native and "position 8" in native


def test_native_multiline_fasta_and_crlf(tmp_path, monkeypatch):
    f = tmp_path / "wrap.fna"
    f.write_bytes(b">a desc\r\nACGT\r\nACGT\r\n>b\nTTTT\nGGGG\n\n>c\nAAAA\n")
    native, python = both_ways(monkeypatch, lambda: records(F1, f))
    assert native == python == records(F0, f)
    assert native[0] == ("a desc", b"ACGTACGT")
    assert native[2] == ("c", b"AAAA")


@pytest.mark.parametrize("L", [1, 3, 12, 13, 60, 61])
def test_native_postcard_codec_differential(L, monkeypatch):
    """Native codec vs numpy: byte-identical encode, identical decode,
    equal to smafa_tpu's bytes, across partial trailing words."""
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 5, size=(333, L), dtype=np.uint8)
    want = P0.dumps(WS0.from_matrix(codes, 2))
    ws = WS1.from_matrix(codes, 2)

    def roundtrip():
        blob = P1.dumps(ws)
        return blob, P1.loads(want).codes

    (blob_n, codes_n), (blob_p, codes_p) = both_ways(monkeypatch, roundtrip)
    assert blob_n == blob_p == want
    np.testing.assert_array_equal(codes_n, codes)
    np.testing.assert_array_equal(codes_p, codes)


@pytest.mark.parametrize("body", ["", "not a fastx\n"])
def test_native_empty_and_garbage(tmp_path, monkeypatch, body):
    f = tmp_path / "x.fna"
    f.write_text(body)

    def error():
        with pytest.raises(F1.FastxError) as e:
            list(F1.read_records(f))
        return str(e.value)

    with pytest.raises(F0.FastxError) as e0:
        list(F0.read_records(f))
    native, python = both_ways(monkeypatch, error)
    assert native == str(e0.value)
    assert python.split(":")[0] == native.split(":")[0]
