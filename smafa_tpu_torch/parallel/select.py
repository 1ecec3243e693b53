"""Db layout selection: which runner the query engine builds.

Counterpart of ``smafa_tpu.parallel.select`` (``choose_layout`` /
``make_runner``). In a multi-process run (``parallel.multihost``) the
layout is ``sharded``: ``parallel.sharded.ShardedRunner`` shards the
db's rows over the ranks, and each rank serves its shard by the
one-device rule below. ``smafa_tpu`` picks its column-sharded layout
there at windows of ``COL_SEQ_THRESHOLD`` bp or more; the port has no
``col`` yet and keeps ``sharded`` (same output; ROADMAP.md, queue 1
item 3.4). On one device two layouts serve the same exact hit-mode
contract (``parallel.hitops.HitModesMixin``):

- ``sharded``: ``parallel.runner.ScanRunner``, the db resident on the
  card as codes and embedded twin, global packed keys
  ``(dist << shift) | idx``;
- ``stream``: ``parallel.slab.SlabStreamRunner``, the db scanned in row
  slabs with slab-local keys merged as (dist, index) pairs, so any row
  count packs, at any window length below 2^25 - 1 bp; its slabs stay on
  the card when they fit (``slab.CODES_RESIDENT_FRACTION``), else they
  stream from host memory every pass.

Where global keys overflow, ``smafa_tpu`` streams too, unless a span of
2^24 rows cannot pack either (windows of 127 bp or more); it then serves
the db with its exact top-M sort-merge (``topm_scan``). The port's slabs
are never wider than ``keys.packing_span``, so the stream layout serves
that case as well, with the same output; a forced ``sharded`` past the
global budget also streams. Only windows of 2^25 - 1 bp or more, where
not even a 64-row tile packs, raise ``KeyPackingError``.

``SMAFA_TPU_LAYOUT`` is ``auto`` (the default), ``sharded`` or
``stream`` (in a multi-process run a forced ``stream`` scans the whole
db on every rank); ``ring`` and ``col`` (``smafa_tpu``'s other
multi-device layouts) are not ported and raise ``LayoutNotPortedError``,
which the CLI reports with exit 101. ``SMAFA_TPU_HBM_BYTES`` overrides the card's memory, as
it does in ``smafa_tpu``.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K
from smafa_tpu_torch.parallel import multihost
from smafa_tpu_torch.parallel.runner import KeyPackingError, ScanRunner

logger = logging.getLogger("smafa")

# Stream the db when its resident form needs more than this fraction of
# the card's memory (programs need working space beside it).
HBM_FRACTION = 0.75

# smafa_tpu.parallel.select.COL_SEQ_THRESHOLD: where it takes the
# column-sharded layout on more than one device
COL_SEQ_THRESHOLD = 8192


class LayoutNotPortedError(ValueError):
    def __init__(self, layout: str):
        super().__init__(f"SMAFA_TPU_LAYOUT={layout} is not ported to "
                         "smafa_tpu_torch yet (see ROADMAP.md); use "
                         "smafa_tpu for it")


def hbm_capacity(device: torch.device) -> int | None:
    """The card's memory in bytes: ``SMAFA_TPU_HBM_BYTES`` if set, else
    ``torch.cuda.mem_get_info``'s total for a CUDA device, else None."""
    env = os.environ.get("SMAFA_TPU_HBM_BYTES")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def resident_row_bytes(seq_len: int) -> int:
    """Device bytes a db row takes in the form the kernels read: its int8
    embedded twin, its uint8 codes and its int32 zc."""
    return D.embed_width(seq_len) + seq_len + 4


def choose_layout(n_windows: int, seq_len: int, device: torch.device,
                  one_device: bool = False) -> str:
    """``sharded`` or ``stream`` for a db of ``n_windows`` windows of
    length ``seq_len`` on ``device``: ``smafa_tpu.parallel.select``'s
    rule, ``sharded`` in a multi-process run, else (or with
    ``one_device``, for a rank's own shard) the one-device rule."""
    env = os.environ.get("SMAFA_TPU_LAYOUT", "auto").lower()
    if env in ("ring", "col"):
        raise LayoutNotPortedError(env)
    if env in ("sharded", "stream"):
        return env
    if env not in ("", "auto"):
        raise ValueError(f"SMAFA_TPU_LAYOUT={env!r}: expected auto, "
                         "sharded, ring, col, or stream")
    if multihost.comm() is not None and not one_device:
        if seq_len >= COL_SEQ_THRESHOLD and multihost.world_size() > 1:
            logger.info("windows of %d bp: smafa_tpu takes its column-"
                        "sharded layout here, which waits for ROADMAP.md "
                        "queue 1 item 3.4; the sharded layout serves them",
                        seq_len)
        return "sharded"
    if K.packing_shift(seq_len, max(2, 2 * n_windows)) is None:
        # Global keys overflow 31 bits; the stream layout packs per slab.
        if K.packing_span(seq_len) is None:
            raise KeyPackingError(
                f"windows of length {seq_len} do not pack into 31-bit keys "
                "even over one 64-row tile (windows of 2^25 - 1 bp or "
                "more); smafa_tpu's top-M sort-merge for them is not "
                "ported (see ROADMAP.md, queue 1 item 5)")
        return "stream"
    cap = hbm_capacity(device)
    if (cap is not None
            and resident_row_bytes(seq_len) * n_windows > HBM_FRACTION * cap):
        return "stream"
    return "sharded"


def make_runner(codes: np.ndarray, seq_len: int, device: torch.device):
    """The chosen layout's runner over the uint8 [W, L] code matrix."""
    if multihost.comm() is not None and choose_layout(
            int(codes.shape[0]), seq_len, device) == "sharded":
        from smafa_tpu_torch.parallel.sharded import ShardedRunner

        logger.debug("db layout: sharded over %d processes (%d windows, "
                     "length %d)", multihost.world_size(), codes.shape[0],
                     seq_len)
        return ShardedRunner(codes, seq_len, device)
    return one_device_runner(codes, seq_len, device)


def one_device_runner(codes: np.ndarray, seq_len: int, device: torch.device):
    """The one-device rule's runner over the uint8 [W, L] code matrix."""
    n = int(codes.shape[0])
    layout = choose_layout(n, seq_len, device, one_device=True)
    logger.debug("db layout: %s (%d windows, length %d)",
                 layout, n, seq_len)
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    if layout == "sharded" and K.packing_shift(seq_len, wp) is None:
        # forced past the global key budget: ScanRunner cannot pack it
        logger.debug("sharded layout past the global key budget: the "
                     "stream layout serves it")
        layout = "stream"
    if layout == "stream":
        from smafa_tpu_torch.parallel.slab import SlabStreamRunner

        return SlabStreamRunner(codes, seq_len, device)
    return ScanRunner(codes, seq_len, device)
