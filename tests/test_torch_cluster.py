"""End to end on the CPU: smafa_tpu_torch's ``cluster`` CLI prints byte
for byte what smafa_tpu's prints, on the golden data at several
divergences; errors keep their texts and exit codes, with the lines of
the records before them printed first. Exact equality throughout.

The port's test files hold at most 21 tests each: pytest-xdist's
loadfile scheduler hands files out largest first, and
tests/test_chunked_ingest.py (21 tests, measuring a child's peak RSS)
must start on a worker that has not imported torch (ROADMAP.md queue 3)."""

from __future__ import annotations

import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1

D = "tests/data"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SMAFA_TPU_TORCH_DEVICE", "cpu")


def run(capsys, main, *argv):
    code = main(list(argv))
    cap = capsys.readouterr()
    lines = cap.err.strip().splitlines()
    return code, cap.out, lines[-1] if lines else ""


def both(capsys, *argv):
    return [run(capsys, main, *argv) for main in (main0, main1)]

CLUSTER_FILES = ["cluster_bug1.fna", "cluster_dummy1.fna",
                 "cluster_best_hit_changes.fna", "random_3_2.fna",
                 "random_3_2_one_repeated.fna", "subjects.fa"]


@pytest.mark.parametrize("fname", CLUSTER_FILES)
def test_cluster_cli_matches_jax(capsys, fname):
    for maxdiv in ("0", "1", "2", "5"):
        r0, r1 = both(capsys, "cluster", "-i", f"{D}/{fname}", "-d", maxdiv,
                      "--quiet")
        assert r0[0] == r1[0] == 0
        assert r1[1] == r0[1] and r1[1], maxdiv


def test_cluster_golden_bug1(capsys):
    # reference cluster.rs:114-125, through the port's CLI
    code, out, _ = run(capsys, main1, "cluster", "-i", f"{D}/cluster_bug1.fna",
                       "-d", "2")
    assert code == 0
    assert out == ("ATGCAAAAA\tATGCAAAAA\nATAAAAAAA\tATGCAAAAA\n"
                   "TTAAAAAAA\tTTAAAAAAA\n")


@pytest.mark.parametrize("extra", [["--batch-size", "1"], ["--batch-size", "2"], []])
def test_invalid_base_streams_prefix(capsys, tmp_path, extra):
    """Lines of the records before an invalid base print, then the same
    error and exit 101."""
    fa = tmp_path / "x.fna"
    fa.write_text(">a\nATGCAAAAA\n>b\nATAAAAAAA\n>c\nTTAAAAAAA\n>d\nAXGCAAAAA\n")
    r0, r1 = both(capsys, "cluster", "-i", str(fa), "-d", "2", "--quiet", *extra)
    assert r0[0] == r1[0] == 101
    assert r1 == r0 and "Byte 88" in r1[2]
    assert r1[1].count("\n") == 3


@pytest.mark.parametrize("text", [
    ">a\nACGT\n>b\nACG\n",              # length mismatch
    ">a\nACGT\n>a2\nACGT\n>b\nAC\n",   # after a duplicate
    ">a\nACGTA\n>b\nACGTT\n>c\nACGTTC\n",
])
@pytest.mark.parametrize("depth", ["1", "2"])
def test_length_mismatch_matches_reference(capsys, monkeypatch, tmp_path,
                                           text, depth):
    """The lines before a record of another width print, then the
    reference's length error (lib.rs:71-78). smafa_tpu gives that at
    pipeline depth 1; at depth 2 it checks a centroid set that is still
    empty and clusters the short record (ROADMAP.md queue 3)."""
    fa = tmp_path / "e.fna"
    fa.write_text(text)
    argv = ["cluster", "-i", str(fa), "-d", "1", "--quiet", "--batch-size", "1"]
    monkeypatch.setenv("SMAFA_TPU_CLUSTER_PIPELINE", "1")
    r0 = run(capsys, main0, *argv)
    monkeypatch.setenv("SMAFA_TPU_CLUSTER_PIPELINE", depth)
    r1 = run(capsys, main1, *argv)
    assert r0[0] == r1[0] == 101
    assert r1 == r0 and "Cannot compute distances" in r1[2]


def test_empty_sequence_error(capsys, tmp_path):
    """The reference's push_encoding text (lib.rs:91-111); smafa_tpu
    fails earlier with an internal dtype error (ROADMAP.md queue 3)."""
    fa = tmp_path / "e.fna"
    fa.write_text(">a\n\n")
    code, out, err = run(capsys, main1, "cluster", "-i", str(fa), "-d", "1")
    assert (code, out, err) == (101, "", "Cannot add empty sequence to WindowSet")


@pytest.mark.parametrize("argv", [
    ["cluster", "-i", f"{D}/cluster_bug1.fna"],
    ["cluster", "-i", f"{D}/missing.fna", "-d", "1"],
])
def test_cluster_errors_match_jax(capsys, argv):
    r0, r1 = both(capsys, *argv)
    assert r0[0] == r1[0] == 101
    assert r1 == r0


def test_cluster_output_file(capsys, tmp_path):
    outs = []
    for i, main in enumerate((main0, main1)):
        out = tmp_path / f"out{i}.tsv"
        assert run(capsys, main, "cluster", "-i", f"{D}/subjects.fa", "-d", "3",
                   "-o", str(out))[0] == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]


def test_cpu_cluster_launches_no_kernel(capsys):
    from smafa_tpu_torch.ops import min_count

    min_count.launches = 0
    assert run(capsys, main1, "cluster", "-i", f"{D}/subjects.fa", "-d", "1")[0] == 0
    assert min_count.launches == 0
