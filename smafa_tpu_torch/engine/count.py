"""count op: reads/bases per FASTX file, JSON output.

Port of ``smafa_tpu.engine.count`` (reference lib.rs:371-398): one JSON
array line with objects in serde derive-order
``{"path", "num_reads", "num_bases"}`` and compact separators (pinned by
reference tests/test_cmdline.rs:184-201). Host only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Iterable, TextIO

from smafa_tpu_torch.io.fastx import read_records


def count(paths: Iterable[str | Path], out: TextIO | None = None) -> None:
    out = out or sys.stdout
    results = []
    for path in paths:
        num_reads = 0
        num_bases = 0
        for _rid, seq in read_records(path):
            num_reads += 1
            num_bases += len(seq)
        results.append({"path": str(path), "num_reads": num_reads, "num_bases": num_bases})
    out.write(json.dumps(results, separators=(",", ":")) + "\n")
