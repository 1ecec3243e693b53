"""makedb op: stream subject FASTX -> encoded WindowSet -> db file.

Parity with reference ``makedb`` (reference lib.rs:137-165): enforces
uniform sequence length with the same error texts, and by default writes
the byte-exact postcard v2 format (so the output is interchangeable with
reference-produced dbs). ``fmt="native"`` writes the raw native
format instead (see smafa_tpu_torch.io.native_format) for large-scale serving.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

from smafa_tpu_torch.core.windowset import WindowSet
from smafa_tpu_torch.io import postcard
from smafa_tpu_torch.io.fastx import read_encoded_batches

logger = logging.getLogger("smafa")

CURRENT_DB_VERSION = 2  # reference lib.rs:18


def makedb(subject_fasta: str | Path, db_path: str | Path, fmt: str = "postcard") -> None:
    logger.debug("Opening subject fasta file: %s", subject_fasta)
    logger.info("Encoding subject sequences ..")
    t0 = time.time()
    windows = WindowSet(version=CURRENT_DB_VERSION)
    try:
        for ids, _raws, codes in read_encoded_batches(subject_fasta, batch_size=8192):
            windows.push_batch(codes)
    except FileNotFoundError:
        # Reference panic text on open failure (lib.rs:144).
        raise ValueError(f"valid path/file of subject fasta: {subject_fasta}")
    logger.info(
        "Encoding of %d sequences complete, writing db file %s",
        len(windows), str(db_path),
    )
    if fmt == "postcard":
        Path(db_path).write_bytes(postcard.dumps(windows))
    elif fmt == "native":
        from smafa_tpu_torch.io import native_format

        native_format.save(windows, db_path)
    else:
        raise ValueError(f"Unknown db format: {fmt}")
    logger.info("DB file written (%.2fs)", time.time() - t0)
