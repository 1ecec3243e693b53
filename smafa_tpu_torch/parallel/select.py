"""Db layout selection: which runner the query engine builds.

Counterpart of ``smafa_tpu.parallel.select`` (``choose_layout`` /
``make_runner``). In a multi-process run (``parallel.multihost``) the
layout is ``sharded``: ``parallel.sharded.ShardedRunner`` shards the
db's rows over the ranks, and each rank serves its shard by the
one-device rule below. At windows of ``SMAFA_TPU_COL_SEQ_THRESHOLD``
(default ``COL_SEQ_THRESHOLD``) bp or more over more than one process
it is ``col``, as in ``smafa_tpu``, while the col layout's ranks on a
card fit it (``col_bytes``). The rule stays ``smafa_tpu``'s until it is
measured with one card a rank over NCCL: with two ranks sharing one
H100 over gloo, ``sharded`` ran 29,903 bp windows faster than ``col``
(3.33-3.45 s against 3.90-5.23 s for 4,096 reads; PERF.md, section 7).
On one device three layouts serve the same exact hit-mode contract
(``parallel.hitops.HitModesMixin``):

- ``sharded``: ``parallel.runner.ScanRunner``, the db resident on the
  card as codes and embedded twin, global packed keys
  ``(dist << shift) | idx``;
- ``stream``: ``parallel.slab.SlabStreamRunner``, the db scanned in row
  slabs with slab-local keys merged as (dist, index) pairs, so any row
  count packs, at any window length below 2^25 - 1 bp; its slabs stay on
  the card when they fit (``slab.CODES_RESIDENT_FRACTION``), else they
  stream from host memory every pass;
- ``wide``: ``parallel.wide.WideRunner``, for windows of 2^25 - 1 bp or
  more (``keys.wide_route``), where not even a 64-row tile packs a key:
  each batch's exact int32 distance block, from which every hit mode
  reads.

Where global keys overflow, ``smafa_tpu`` streams too, unless a span of
2^24 rows cannot pack either (windows of 127 bp or more); it then serves
the db with its exact top-M sort-merge (``topm_scan``). The port's slabs
are never wider than ``keys.packing_span``, so the stream layout serves
that case as well, with the same output; a forced ``sharded`` past the
global budget also streams. Where not even a 64-row tile packs, the
wide route serves, forced ``sharded`` and ``stream`` included; a forced
``ring`` raises ``KeyPackingError`` there, as ``smafa_tpu``'s ring
does. A forced ``col`` runs: its min2 fold is the pair form and it
packs no key.

``SMAFA_TPU_LAYOUT`` is ``auto`` (the default), ``sharded``, ``stream``
(in a multi-process run a forced ``stream`` scans the whole db on every
rank), ``ring`` (``parallel.ring.RingRunner``: db shards rotate around
the ranks) or ``col`` (``parallel.seqpar.ColumnShardedRunner``: each
rank holds a column slice of every row). A forced ``ring`` or ``col``
runs over the run's processes, or in a single-process run over one rank
(``comm.LocalComm``), as ``smafa_tpu`` builds them over a one-device
mesh. ``SMAFA_TPU_HBM_BYTES`` overrides the card's memory, as it does in
``smafa_tpu``.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import keys as K
from smafa_tpu_torch.parallel import multihost
from smafa_tpu_torch.parallel.runner import ScanRunner

logger = logging.getLogger("smafa")

# Stream the db when its resident form needs more than this fraction of
# the card's memory (programs need working space beside it).
HBM_FRACTION = 0.75

# smafa_tpu.parallel.select.COL_SEQ_THRESHOLD: where it takes the
# column-sharded layout on more than one device
COL_SEQ_THRESHOLD = 8192


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


def fit_batch(seq_len: int, device: torch.device,
              embeds_per_row: int) -> int | None:
    """The largest power-of-two batch whose rows, ``embeds_per_row``
    query embeddings (EP bytes) each, fit the 1 - HBM_FRACTION of the
    card left beside the db; None when the card's memory is unknown. A
    batch row holds its codes, its embedding and the embedding's one-hot
    temporaries, twice with two batches in flight; a cluster row also
    the float32 blocks of the resolve. On an 80 GB card every query tier
    fits it below ~300 kbp, and the cluster's batches of up to 32,768
    records below ~9.5 kbp."""
    cap = hbm_capacity(device)
    if cap is None:
        return None
    rows = max(1, int((1 - HBM_FRACTION) * cap)
               // (embeds_per_row * D.embed_width(seq_len)))
    return 1 << (rows.bit_length() - 1)


def col_bytes(n_windows: int, seq_len: int, size: int) -> int:
    """Device bytes a rank of the col layout over ``size`` ranks takes:
    its column slice of every row's twin and every row's zc, and the
    [B, chunk] int32 blocks of two sweeps in flight (a batch's first pass
    beside the compaction of the batch before), four a sweep: the
    partial product, its sum over the ranks (or, under gloo, its copy
    back from the pinned staging), the distances and a fold's
    temporary, ``seqpar.BLOCK_BYTES`` each."""
    from smafa_tpu_torch.parallel.seqpar import BLOCK_BYTES, column_slice

    c0, c1 = column_slice(seq_len, 0, size)
    return n_windows * (c1 - c0 + 4) + 2 * 4 * BLOCK_BYTES


def choose_layout(n_windows: int, seq_len: int, device: torch.device,
                  one_device: bool = False) -> str:
    """The layout of a db of ``n_windows`` windows of length ``seq_len``
    on ``device``: the forced one, else ``smafa_tpu.parallel.select``'s
    rule: in a multi-process run ``col`` at long windows (see the module
    docstring), else ``sharded``; else (or with ``one_device``, for a
    rank's own shard) the one-device rule, ``sharded``, ``stream`` or
    ``wide``."""
    env = os.environ.get("SMAFA_TPU_LAYOUT", "auto").lower()
    if env in ("sharded", "stream", "ring", "col"):
        return env
    if env not in ("", "auto"):
        raise ValueError(f"SMAFA_TPU_LAYOUT={env!r}: expected auto, "
                         "sharded, ring, col, or stream")
    comm = multihost.comm()
    if comm is not None and not one_device:
        threshold = int(os.environ.get("SMAFA_TPU_COL_SEQ_THRESHOLD",
                                       COL_SEQ_THRESHOLD))
        cap = hbm_capacity(device)
        # every rank on this card holds its own slice and blocks
        need = comm.card_ranks * col_bytes(n_windows, seq_len, comm.size)
        if (comm.size > 1 and seq_len >= threshold
                and (cap is None or need <= HBM_FRACTION * cap)):
            return "col"
        return "sharded"
    if K.packing_shift(seq_len, max(2, 2 * n_windows)) is None:
        # Global keys overflow 31 bits; the stream layout packs per slab,
        # and where not even a tile packs the wide route serves.
        return "wide" if K.wide_route(seq_len) else "stream"
    cap = hbm_capacity(device)
    if (cap is not None
            and resident_row_bytes(seq_len) * n_windows > HBM_FRACTION * cap):
        return "stream"
    return "sharded"


def make_runner(codes: np.ndarray, seq_len: int, device: torch.device):
    """The chosen layout's runner over the uint8 [W, L] code matrix."""
    comm = multihost.comm()
    layout = choose_layout(int(codes.shape[0]), seq_len, device)
    if layout in ("ring", "col"):
        from smafa_tpu_torch.parallel.comm import LocalComm

        if layout == "ring":
            from smafa_tpu_torch.parallel.ring import RingRunner as runner
        else:
            from smafa_tpu_torch.parallel.seqpar import (
                ColumnShardedRunner as runner)
        logger.debug("db layout: %s over %d processes (%d windows, length "
                     "%d)", layout, multihost.world_size(), codes.shape[0],
                     seq_len)
        return runner(codes, seq_len, device,
                      comm=comm if comm is not None else LocalComm())
    if comm is not None and layout == "sharded":
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
    if K.wide_route(seq_len):
        # no 64-row tile packs: a forced sharded or stream takes the wide
        # route too
        from smafa_tpu_torch.parallel.wide import WideRunner

        return WideRunner(codes, seq_len, device)
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
