"""smafa_tpu_torch's ``count`` CLI prints byte for byte what smafa_tpu's
prints: FASTA, gzipped FASTQ, several files and none."""

from __future__ import annotations

import pytest

from smafa_tpu.cli import main as main0
from smafa_tpu_torch.cli import main as main1

D = "tests/data"


def run(capsys, main, *argv):
    code = main(list(argv))
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def both(capsys, *argv):
    return [run(capsys, main, *argv) for main in (main0, main1)]


@pytest.mark.parametrize("argv", [
    ["count", "-i", f"{D}/random_3_2.fna"],
    ["count", "-i", f"{D}/random_30_4.fq.gz"],
    ["count", "-i", f"{D}/random_3_2.fna", f"{D}/random_30_4.fq.gz"],
    ["count", "-i"],
])
def test_count_matches_jax(capsys, argv):
    r0, r1 = both(capsys, *argv)
    assert r0[0] == r1[0] == 0
    assert r1[1] == r0[1]


def test_count_golden(capsys):
    # reference tests/test_cmdline.rs:184-201, through the port
    code, out, _ = run(capsys, main1, "count", "-i", f"{D}/random_30_4.fq.gz")
    assert code == 0
    assert out == ('[{"path":"tests/data/random_30_4.fq.gz","num_reads":4,'
                   '"num_bases":120}]\n')
