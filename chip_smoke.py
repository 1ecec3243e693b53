"""Card smoke test of the PyTorch port (smafa_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
Phases, one line each:

0. device: the card's name and power limit (nvidia-smi) and the
   torch/CUDA versions; fails when no CUDA device is visible.
1. build: compiles the CUDA kernels from smafa_tpu_torch/csrc with nvcc;
   logs each source's ``ptxas -v`` (registers, spills) and, where the
   toolkit has cuobjdump, the warpgroup MMA and TMA load instructions
   of the hist kernels and of the four scans' kernels (min2,
   compact_mask, kstats, min_count) on both their routes (fails if one
   of them has none of either, or if one of those but hist's has an
   mma.sync, ldmatrix or cp.async instruction).
2. kernel parity: each kernel against its plain PyTorch version on the
   card, exact equality (all values are integers), with both times and
   the kernel's bound (the larger of its int8 operations over 1,979
   TOP/s and its bytes over 3.35 TB/s, the H100 SXM's dense peaks).
   min_count, with and without the count, at L = 3, 60, 150, 300 over a
   live buffer (each line with the route and db splits of both n_valid:
   the wgmma tile to 64 bp, the K-chunked tile past it), then at its
   split shapes, each line
   with its route and db splits (the cluster's batches B = 1, 77, 2048, 32768 against
   29,321 live rows of a 32,768-row buffer; n_valid = 37 and 3001 with
   query copies past n_valid; a db of one repeated row; a db whose only
   exact match is its last live row; 63, 64 and 150 bp); timed at the
   cluster path's 32768 x 32768, 8192 x 16384 and 2048 x 4096, by CUDA
   events around back-to-back calls and by the profiler's device time
   of the kernel and its merge (``device_ms``), which leaves out the
   host's launch gaps.
   min2 also at its split-W shapes (B = 1, 16, 77 x 2^20 + 37 rows), one
   64-row tile, a db of one repeated row (cnt = every row) and a db whose
   only exact match is its last real row; timed at the main-path batch
   and at B = 512 and 4096. compact_mask, each line with its route and
   db splits, timed at B = 512 and 4096 x 2^20; also at its split shapes
   (B = 1, 77 x 2^20 + 37), at thresh = L (every real window set) and on
   its long route at L = 150 (timed at 4096 x 2^20).
3. end to end through the CLI: makedb --format native over a seeded
   2^20-window 60 bp db, then best-hit query of 65,536 reads at
   --max-divergence 5; checks the exit codes, that both kernels launched
   during the run, and 512 sampled queries' lines against a numpy
   brute force.
4. K-mode: the kstats kernel against its plain version on the card,
   exact, each line with its route and db splits, at B = 16384 and 4096
   against 2^20 + 37 db rows (timed, with one whole K = 99 cutoff search
   of 3 passes and their merges, held to its plain version), at B = 1
   and 77 (many splits) and at n_valid = 37 (one partial tile); compact_mask
   against its plain version, exact, at the K-mode compaction's shape
   (8192 reads x phase 3's 2^20-window db, per-row thresholds the K = 99
   cutoffs); then K-mode query through the CLI on phase 3's db: (a)
   16,384 reads at --max-num-hits 99 (one batch), (b) 4,096 reads at
   --max-num-hits 99 --max-divergence 5 --limit-per-sequence 1, (c)
   65,536 reads at --max-num-hits 99 --max-divergence 5 in 4 batches
   (the next batch's cutoff passes overlap the current one's compaction
   and emit); checks the exit codes, kstats_steps(60) = 3 kstats
   launches per batch, that compact_mask launched, and 256 sampled
   reads' lines of each run against a numpy brute force of the reference
   rule (lib.rs:241-295). The hist kernel (K-mode's one-pass cutoff
   program under SMAFA_TPU_KMODE_HIST=1) against its plain version,
   exact, each line with its route, db splits, query rows a block and
   bin bytes a block: at B = 16384 and 4096 x (2^20 + 37) (timed beside
   one kstats pass's bound, the whole K = 99 kstats search and the
   histogram's own cutoffs, whose eff and hits must equal the search's),
   at B = 1 and 77 (many splits), n_valid = 37, a db of one repeated
   row, and L = 3 and 64; each K-mode run again with the switch, its
   sha256 equal to the run's, one hist launch a batch and no kstats.
5. cluster through the CLI at BASELINE.json config 4: 1M 60 bp records
   from tools/cluster_bench.py's generator (4000 ancestors, 0-4
   mutations, seed 0) at -d 5; checks the exit code, that the min_count
   kernel launched, one line per distinct record, every centroid within
   5 of its record, the centroid count and output hash smafa_tpu gives
   on this input, and a greedy oracle on 512 sampled records; the
   (B, n_valid) of every min_count launch, replayed after the run for
   the kernel's summed device ms (the profiler's, without the host's
   launch gaps) beside the wall. Then ``count`` on the same file.
6. host parity: the native host runtime against its pure-Python paths
   (SMAFA_TPU_NO_NATIVE=1, toggled in this process) on the same data,
   both timed: read_encoded_batches on the query smoke's reads and on
   cluster 1M's input (ids, raws, codes), the query smoke's emit (bytes,
   also equal to its output file), postcard dumps/loads of the 2^20-row
   db (bytes, codes). Any difference fails the run.
7. resume: the query smoke through the engine, crashed (a torn write)
   in its second batch, then ``query --resume-state`` through the CLI
   on the same file: the bytes of the straight run. Cluster 1M crashed
   after the batch that passes half its records, then ``cluster
   --resume-state`` through the CLI: smafa_tpu's sha256 and centroid
   count. Logs the resumed walls and the seconds spent re-filtering the
   prefix.
8. stream: the out-of-core stream layout (parallel/slab.py) and the
   layout choice (parallel/select.py). (a) The query smoke's best-hit
   run and K-mode run (b) again through the CLI with
   SMAFA_TPU_LAYOUT=stream in 4 slabs of 2^18 rows, in the resident
   tier, then the streaming tier (SMAFA_TPU_SLAB_RESIDENT=0): each
   output byte-equal to phases 3 and 4's, min2 launched once per slab
   per batch, kstats 3 times. (b) A seeded db of 2^25 + 2^20 =
   34,603,008 windows (random_db's duplicate groups, plus groups of 2,
   5 and 40 across every slab boundary and across index 2^25) written
   in the native format, queried through the CLI with no layout
   variable: the log must show the stream layout chosen, its resident
   tier and the slab plan. 65,536 reads (a third from indices >= 2^25)
   at --max-divergence 5, then 16,384 reads at --max-num-hits 99; each
   again with SMAFA_TPU_SLAB_RESIDENT=0, bytes equal; min2 once per
   slab per batch, kstats 3 per slab, compact_mask launched; 64 sampled
   reads a run against a brute force over the uint8 codes in plain
   torch on the card. Each run logs its wall, stages, reads/s,
   comparisons/s over the scan stage, the seconds and bytes of the
   host-to-device copies of db codes and the host seconds filling their
   staging buffers, beside the card's name and power limit. The db file
   is deleted at the end.
9. long windows: 2^22 + 2^20 = 5,242,880 windows of 150 bp (random_db's
   duplicate groups, plus groups across the slab edge) in the native
   format, queried through the CLI with no layout variable. Global keys
   (8 distance + 24 index bits) do not pack, nor does smafa_tpu's
   2^24-row span, so smafa_tpu takes its top-M sort-merge there; the log
   must show the port's auto rule choosing the stream layout, its
   resident tier and 2 slabs of 2,621,440 rows at shift 22. 32,768
   reads (0-15 substitutions, a third from the second slab) at
   --max-divergence 12, then 4,096 at --max-num-hits 99, each again with
   SMAFA_TPU_SLAB_RESIDENT=0, bytes equal; min2 once and kstats 4 times
   per slab per batch, compact_mask launched; 64 sampled reads a run
   against the brute force. Then min2, kstats and compact_mask on their
   long routes at this phase's shapes (one slab each), exact against
   their plain versions, timed by CUDA events beside their bounds, each
   line with its route and db splits (form (a), "wg_kchunk", the
   K-chunked wgmma tile), and hist at the K-mode batch x one slab beside the
   whole 4-pass kstats search there. Then, exact and timed (``cell:
   long_routes``), on 32,768 random rows: min2 at 4,096 reads, kstats at
   1,024 and compact_mask at 4,096 (300 bp) and 1,024 (29,903 bp) reads
   at their K = 99 cutoffs, at 300 bp and at 29,903 bp (form (b), route
   "wg_kchunk_stream"); min_count at 32,768 reads at 150 bp (form (a),
   "wg_kchunk"); and
   hist at 1,024 reads at 300 and 1023 bp (the widest window the switch
   takes), beside the kstats search (5 passes) there. The K = 99 run
   also runs with SMAFA_TPU_KMODE_HIST=1: bytes equal, hist once per
   slab per batch. The db file is deleted at the end.
10. cluster spans: (a) cluster 1M through the CLI again with the port's
   key budget cut in-process to 12 index bits (``keys.packing_shift``
   patched, as the CPU tests do; the package has no knob for it), so
   the 32,768-row buffer scans in spans of 4,096 rows: phase 5's
   centroid count and sha256, one min_count launch per span per batch.
   (b) ``_CentroidStore.from_codes`` over 5,242,880 random 300 bp
   centroids: cap 2^23 does not pack at 9 distance bits, so it scans 2
   spans of 2^22 rows; one batch of 32,768 reads through ``scan_async``
   / ``scan_fetch``, timed, 256 sampled rows (64 of them exact copies of
   rows duplicated across the spans) against a brute force on the card,
   and min_count on its first span exact against its plain version and
   timed (the K-chunked wgmma tile, form (b)). A whole cluster run past the real budget is O(n^2), so (b)
   drives the engine's store, not the CLI.
11. multiprocess: ``query`` and ``cluster`` through the CLI as 2 ranks
   (subprocesses of this script, ``--rank``, each with its kernels'
   counts set to 0 before and read after its run) sharing the card over
   gloo, ``--coordinator 127.0.0.1:<free port>``, each rank holding one
   row shard. (a) BASELINE config 5 cut to one card: 10,000,000 windows
   of 60 bp from random_db in the native format (5,000,000 a rank),
   best-hit on 65,536 reads at --max-divergence 5 and K = 99 on 16,384
   reads, both with the query split: sha256 equal to the port's
   single-process run on the same files, 64 sampled reads a run equal
   to a brute force; the K = 99 run again with SMAFA_TPU_KMODE_HIST=1,
   sha256 equal, hist launched on each rank and kstats on none. (b)
   phase 8's 34,603,008-window db (kept from phase
   8) in 2 ranks, where global keys overflow and each shard packs
   alone: phase 8's best-hit sha256. (c) cluster 1M in 2 ranks: phase
   5's sha256 and 29,321 centroids. (d) one rank with a coordinator,
   whose device collectives take NCCL on the card, on (a)'s best-hit
   run: its sha256. Each line logs the walls, stages, reads/s, launches
   and the merges' seconds of every rank; two ranks on one card measure
   contention, not scaling.
12. layouts: ``query`` through the CLI under SMAFA_TPU_LAYOUT=ring and
   col, as ranks like phase 11's. (a) the ring (db shards rotate around
   the ranks) on phase 11 (a)'s db and reads in 2 ranks over gloo: each
   sha256 equal to phase 11's single-process run, 64 sampled reads a run
   against the brute force, every rank launching min2 (best-hit),
   kstats and compact_mask (K-mode) on the shards it holds, with its
   rotations, bytes rotated and seconds in rotate and in the gathers;
   then 1 rank on NCCL. (b) 32,768 random windows of 29,903 bp (a
   SARS-CoV-2 genome's width): best-hit on 4,096 reads at
   --max-divergence 300 in 2 ranks under col and under sharded, timed
   side by side (the times behind the auto rule), and K = 99 on 1,024
   reads in 2 ranks under the auto rule (col), each sha256 equal to the
   single process's (the single K = 99 run again with
   SMAFA_TPU_KMODE_HIST=1: bytes equal, no hist launch, as 29,903 bp is
   past HIST_MAX); then col in 1 rank on NCCL. (c) the query smoke's
   best-hit run in a process of its own, untraced and with
   SMAFA_TPU_TRACE_DIR set: one torch.profiler trace that names the min2
   kernel, and the smoke's bytes both times.
13. wide_windows: (a) 128 windows of 2^25 bp, where no 64-row tile
   packs a key, written as FASTA and built by makedb through the CLI:
   16 reads best-hit with and without --max-divergence 2000, K = 3 on 8
   with and without --limit-per-sequence 1, and best-hit under a forced
   stream layout with the card's memory cut to 20.6 GB (the wide
   route's slab tier), each sha256 equal to a brute force on the card; the
   dist_block kernel exact against its plain version at 16 x 128 and
   timed beside its bound (``kernel_time`` with ``cell: wide_windows``),
   and beside one torch._int_mm of the same block (``library_time``).
   (b) cluster of 48 records of 2^25 bp at -d 1000 against a greedy
   oracle on the card. (c) 64 windows of 25,165,824 bp (1.5 x 2^24):
   the plain ``distances`` on the card at a pair whose dot is odd and
   above 2^24, equal to code comparison where one float32 product over
   all columns is off; best-hit on 8 reads against the brute force, and
   a cluster of 32
   records, whose resolve takes the plain distance products, against
   the oracle.

After the kernels' build, ``native_build`` builds the native host
library (g++; a failed build fails the run) and logs g++'s version, the
seconds and the library's name. Spies count the calls of the native
parse (``parse_buffer``), emit (``format_hits_tsv_codes``) and dedup
(``dedup_filter``) in the query smoke, K-mode run (a) and cluster 1M,
logged beside the kernel launches; a count of 0 where that path must
run natively fails the run.

Before the last line it prints the kernels' JSON summary and the card's
name and power limit; the last line is the run's JSON verdict. Any
failure raises, which exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np
import torch

L_SMOKE = 60
MIN2_SOURCE = "smafa_tpu_torch/csrc/min2.cu"
COMPACT_SOURCE = "smafa_tpu_torch/csrc/compact.cu"
MIN2_REPLACES = "smafa_tpu/ops/pallas_scan.py:311"     # _min2_kernel
COMPACT_REPLACES = "smafa_tpu/ops/pallas_scan.py:463"  # _compact_kernel
MIN_COUNT_SOURCE = "smafa_tpu_torch/csrc/min_count.cu"
MIN_COUNT_REPLACES = "smafa_tpu/ops/pallas_scan.py:152"  # _min_kernel
KSTATS_SOURCE = "smafa_tpu_torch/csrc/kstats.cu"
# not a Pallas kernel: the XLA pass _statsN_pass of the K-mode cutoff search
KSTATS_REPLACES = "smafa_tpu/ops/distance.py:1302"
HIST_SOURCE = "smafa_tpu_torch/csrc/hist.cu"
# not a Pallas kernel: the XLA program hist_scan, K-mode's cutoff pass
# under SMAFA_TPU_KMODE_HIST=1
HIST_REPLACES = "smafa_tpu/ops/distance.py:1087"
KMODE_HIST = "SMAFA_TPU_KMODE_HIST"  # the switch of the histogram pass

# What smafa_tpu prints for the cluster phase's input (tools/cluster_bench.py
# defaults, -d 5), from its CPU run: distinct centroids and the sha256
# of stdout (docs/PERFORMANCE.md:61-63 pins the count).
CLUSTER_CENTROIDS = 29321
CLUSTER_SHA256 = "0fd93d0c300d7934aa77c9fda8ce32d48be143d92890382f88098c3b444f6db2"


def smoke_sizes(query_mod) -> types.SimpleNamespace:
    """The run's shapes: the db and query stream of BASELINE.json config 3
    (1M-sequence db, 60 bp windows) cut to 65,536 reads, and the issue's
    kernel parity shapes."""
    db_rows = 1 << 20
    return types.SimpleNamespace(
        db_rows=db_rows, queries=65536, sample=512, reps=10,
        parity_rows=(1 << 20) + 37, parity_queries=4096,
        # min2's split-W batches against parity_rows, and the rows of its
        # exact-path dbs (one repeated row; best match the last row)
        split_queries=(1, 16, 77), exact_rows=70001,
        parity_rows_compact=1 << 20, compact_rows=4096,
        # min_count: a centroid buffer below / at its row count, and the
        # cluster path's batch x centroid-buffer shapes (late, middle,
        # early)
        min_count_rows=16384, min_count_below=10007,
        # (B, W, which, reps): the short early launch takes more reps
        min_count_times=((32768, 32768, "main", 10), (8192, 16384, "mid", 30),
                         (2048, 4096, "early", 100)),
        # min_count's split shapes: the cluster's batches against 29,321
        # centroids live in a 32,768-row buffer
        min_count_split_queries=(1, 77, 2048, 32768),
        min_count_split_rows=(29321, 32768),
        cluster_records=1_000_000, cluster_div=5,
        # kstats parity (the K-mode batches of runs a/c and b x db) and
        # the K-mode runs: (name, reads, max_divergence,
        # limit_per_sequence, batch size)
        kstats_queries=((16384, "main"), (4096, "run_b")),
        kstats_rows=(1 << 20) + 37, kmode_k=99,
        # kstats' split shapes: (B, n_valid) in the same buffer
        kstats_split_shapes=((1, (1 << 20) + 37), (77, (1 << 20) + 37),
                             (300, 37)),
        kmode_runs=(("a", 16384, None, None, 16384), ("b", 4096, 5, 1, None),
                    ("c", 65536, 5, None, 16384)),
        # hist's split shapes at 60 bp: (B, n_valid, db) against
        # kstats_rows, db "random" or "repeated" (one row); then (B, L)
        # at the narrowest and widest windows of the short route
        hist_split_shapes=((1, (1 << 20) + 37, "random"),
                           (77, (1 << 20) + 37, "random"),
                           (300, 37, "random"),
                           (300, (1 << 20) + 37, "repeated")),
        hist_widths=((4096, 3), (4096, 64)),
        kmode_sample=256,
        # phase 8 (b): K-mode reads and sampled reads a run
        stream_kmode_queries=16384, stream_sample=64,
        # phase 9: best-hit and K-mode reads; calls a long-route kernel
        # is timed over; phase 10 (b): reads and sampled reads
        long_queries=32768, long_kmode_queries=4096, long_reps=3,
        span_queries=32768, span_sample=256,
        # the query batch the CLI picks for this db
        main_batch=query_mod._auto_batch(
            types.SimpleNamespace(n_windows=db_rows, runner=None)))


_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line, with the script's seconds so far (``elapsed_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


PEAK_INT8_OPS = 1.979e15  # H100 SXM dense int8 tensor-core peak, op/s
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s


def bound(b: int, rows: int, L: int, ep: int, out_bytes: int,
          extra_in_bytes: int = 0) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time of a scan of b query
    rows against ``rows`` db rows, the larger of its int8 operations
    (2 * b * rows * 4L, the real embedding width) over the int8 peak and
    its bytes (queries, db rows and their zc, other inputs, outputs, each
    once) over the memory rate."""
    t_ops = 2 * b * rows * 4 * L / PEAK_INT8_OPS * 1e3
    nbytes = b * ep + rows * (ep + 4) + extra_in_bytes + out_bytes
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def log_time(kernel: str, L: int, b: int, w: int, ms: float,
             plain_ms: float, bnd: tuple[float, str], **extra) -> dict:
    """Log one kernel_time line; returns its summary fields."""
    t = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
         "bound_by": bnd[1], "bound_share": bnd[0] / ms}
    log("kernel_time", kernel=kernel, L=L, B=b, W=w, **extra, **t,
        comparisons_per_s=b * w / (ms / 1e3))
    return t


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# SASS opcodes of the Hopper machinery the warpgroup kernels must use
SASS_WGMMA = ("HGMMA", "IGMMA", "WGMMA")  # warpgroup MMA (int8: IGMMA)
SASS_TMA = ("UTMALDG",)                   # TMA tensor loads
# and what the four scans' kernels must not use: the retired split
# tile's mma.sync (IMMA), ldmatrix (LDSM) and cp.async (LDGSTS)
SASS_OLD_TILE = ("IMMA", "LDSM", "LDGSTS")
# the warpgroup kernels, by a part of their names: each must be built
# (the short route of min2, compact_mask, kstats and min_count, then
# their long routes)
WG_KERNELS = ("hist_kernel", "min2_wg_kernel", "compact_wg_kernel",
              "kstats_wg_kernel", "min_count_wg_kernel",
              "min2_wgchunk_kernel", "compact_wgchunk_kernel",
              "kstats_wgchunk_kernel", "min_count_wgchunk_kernel")


def warpgroup_sass(build_mod) -> dict:
    """The warpgroup kernels' (hist, the four scans' on both routes)
    warpgroup MMA and TMA load instructions in the built library
    (``cuobjdump -sass``): per kernel their counts and first lines, and
    their count of mma.sync, ldmatrix and cp.async instructions; fails if
    a kind of kernel is missing, if one has none of either, or if one
    but hist's has any of the last three. "not measured" where the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build_mod._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"wg_sass": "not measured (no cuobjdump)"}
    text = subprocess.run([tool, "-sass", str(build_mod.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if any(k in name for k in WG_KERNELS) else None
            if name:
                kernels[name] = {"wgmma": [], "tma": [], "old_tile": []}
        elif name:
            ops = line.split(";")[0]
            for key, names in (("wgmma", SASS_WGMMA), ("tma", SASS_TMA)):
                if any(op in ops for op in names):
                    kernels[name][key].append(line.strip())
            if any(op in ops.replace("IGMMA", "") for op in SASS_OLD_TILE):
                kernels[name]["old_tile"].append(line.strip())
    counts = {n: {k: len(v) for k, v in d.items()} for n, d in kernels.items()}
    missing = [k for k in WG_KERNELS if not any(k in n for n in counts)]
    if (missing or any(c["wgmma"] == 0 or c["tma"] == 0
                       for c in counts.values())
            or any(c["old_tile"] for n, c in counts.items()
                   if "hist_kernel" not in n)):
        raise AssertionError(f"warpgroup kernels without wgmma or TMA, "
                             f"missing ({missing}) or with mma.sync: "
                             f"{counts}")
    return {"wg_sass": {n: {k: {"count": len(v), "first": v[:2]}
                            for k, v in d.items()}
                        for n, d in kernels.items()}}


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, match: str) -> float | None:
    """Mean device milliseconds per fn() of the kernels whose name holds
    ``match``, from torch.profiler's CUDA activity over reps calls after
    one warm-up call; None when the trace shows no device time. Unlike
    ``time_ms`` it leaves out the gaps where the card waits for the host
    to launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if match in e.key)
    return us / 1e3 / reps if us else None


def random_db(rng, n: int, L: int) -> np.ndarray:
    """ACGT windows with planted exact duplicates: 20% of the rows sit in
    duplicate groups of 2, 5 and 40 (an equal share of rows each)."""
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    perm = rng.permutation(n)
    used = 0
    for g in (2, 5, 40):
        k = (n // 5 // 3) // g
        pos = perm[used:used + k * g].reshape(k, g)
        used += k * g
        codes[pos[:, 1:]] = codes[pos[:, :1]]
    return codes


def mutate(rng, rows: np.ndarray, max_subs: int) -> np.ndarray:
    """Copies of ``rows`` with 0..max_subs random substitutions each."""
    q = rows.copy()
    n, L = q.shape
    k = rng.integers(0, max_subs + 1, n)
    pos = rng.integers(0, L, (n, max_subs))
    shift = rng.integers(1, 4, (n, max_subs)).astype(np.uint8)
    for s in range(max_subs):
        sel = np.nonzero(k > s)[0]
        q[sel, pos[sel, s]] = (q[sel, pos[sel, s]] + shift[sel, s]) % 4
    return q


def min2_cases(sizes, rng, rng_m):
    """min2's parity dbs, each (L, codes, the rng of its queries,
    [(B, timed or None), ...]): the first shapes from ``rng`` (so they keep
    their data), then the split-W, one-tile and exact-path shapes from
    ``rng_m``. Generated lazily, one db at a time."""
    n_small = sizes.parity_rows // 8 + 5
    yield (L_SMOKE, random_db(rng, sizes.parity_rows, L_SMOKE), rng,
           [(sizes.parity_queries, "parity")])
    yield (L_SMOKE, random_db(rng, sizes.db_rows, L_SMOKE), rng,
           [(sizes.main_batch, "main")])
    for L in (3, 150):
        codes = random_db(rng, n_small, L) if L > 3 else rng.integers(
            0, 5, (n_small, L), dtype=np.uint8)
        yield L, codes, rng, [(1000, None)]
    yield (L_SMOKE, random_db(rng_m, sizes.db_rows, L_SMOKE), rng_m,
           [(512, "b512")])
    yield (L_SMOKE, random_db(rng_m, sizes.parity_rows, L_SMOKE), rng_m,
           [(b, None) for b in sizes.split_queries])
    yield L_SMOKE, random_db(rng_m, 64, L_SMOKE), rng_m, [(77, None)]
    same = rng_m.integers(0, 4, (1, L_SMOKE), dtype=np.uint8)
    yield (L_SMOKE, np.repeat(same, sizes.exact_rows, axis=0), rng_m,
           [(77, None)])
    yield (L_SMOKE, rng_m.integers(0, 4, (sizes.exact_rows, L_SMOKE),
                                   dtype=np.uint8), rng_m, [(77, "last_row")])


def kernel_parity(sizes, dev, D, K, min2_mod, rng, rng_m) -> dict:
    """Phase 2, min2: kernel vs plain version on the card, exact. Timed
    at B = 4096 x (2^20 + 37), at the main path's query batch (the
    summary's) and at B = 512."""
    timings = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for L, codes, qrng, runs in min2_cases(sizes, rng, rng_m):
        n = codes.shape[0]
        wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
        shift = K.packing_shift(L, wp)
        ep = D.embed_width(L)
        db_emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L, wp)
        for b, timed in runs:
            if timed == "last_row":  # exact and mutated copies of the last row
                q = mutate(qrng, codes[[n - 1] * b], 6)
                q[: b // 2] = codes[n - 1]
            else:
                q = mutate(qrng, codes[qrng.integers(0, n, b)], 6)
                q[: b // 8] = codes[qrng.integers(0, n, b // 8)]  # exact copies
            q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L)
            for with_count in (True, False):
                got = min2_mod.min2(q_emb, db_emb, zc, L, shift, with_count)
                want = D.min2_reference(q_emb, db_emb, zc, L, shift, with_count)
                torch.cuda.synchronize()
                err = max(int((g.long() - w.long()).abs().max())
                          for g, w in zip(got, want))
                if err != 0:
                    raise AssertionError(
                        f"min2 kernel differs from its plain version at L={L} "
                        f"B={b} W={n} with_count={with_count} (max |err| {err})")
                if with_count:
                    min_dist = int(want[0].min()) >> shift
                    max_count = int(want[2].max())
            plan = dict(zip(("route", "splits"),
                            min2_mod.kernel_plan(b, wp, ep, sms)))
            log("kernel_parity", kernel="min2", L=L, B=b, W=n, **plan,
                min_dist=min_dist, max_count=max_count, exact=True)
            if timed in ("parity", "main", "b512"):
                ms = time_ms(lambda: min2_mod.min2(q_emb, db_emb, zc, L, shift), sizes.reps)
                plain_ms = time_ms(lambda: D.min2_reference(q_emb, db_emb, zc, L, shift), 2)
                timings[timed] = log_time(
                    "min2", L, b, n, ms, plain_ms,
                    bound(b, n, L, ep, out_bytes=3 * 4 * b), **plan)
            del q_emb, got, want
        del db_emb, zc
    return {"max_abs_err": 0, **timings["main"]}


def compact_plan(compact_mod, b: int, wp: int, ep: int, dev) -> dict:
    """The route and db splits the compact_mask wrapper launches with."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route, splits = compact_mod.kernel_plan(b, wp, ep, sms)
    return {"route": route, "splits": splits}


def compact_check(compact_mod, D, q_emb, db_emb, zc, thresh, L: int,
                  where: str) -> torch.Tensor:
    """The kernel's mask, held exactly to the plain version's."""
    got = compact_mod.compact_mask(q_emb, db_emb, zc, thresh, L)
    want = D.compact_mask_reference(q_emb, db_emb, zc, thresh, L)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"compact_mask kernel differs from its plain "
                             f"version in {bad} words at {where}")
    return got


def compact_time(sizes, compact_mod, D, q_emb, db_emb, zc, thresh, L: int,
                 n: int, **extra) -> dict:
    """Log compact_mask's kernel_time line at these operands (n real db
    rows); returns its summary fields."""
    b, wp = q_emb.shape[0], db_emb.shape[0]
    ms = time_ms(lambda: compact_mod.compact_mask(
        q_emb, db_emb, zc, thresh, L), sizes.reps)
    plain_ms = time_ms(lambda: D.compact_mask_reference(
        q_emb, db_emb, zc, thresh, L), 2)
    return log_time("compact_mask", L, b, n, ms, plain_ms,
                    bound(b, n, L, D.embed_width(L), out_bytes=b * wp // 8,
                          extra_in_bytes=4 * b), **extra)


def row_hits(mask: torch.Tensor) -> np.ndarray:
    """Set bits of each row of an int32 mask."""
    return np.unpackbits(mask.cpu().numpy().view(np.uint8), axis=1).sum(axis=1)


def compact_parity(sizes, dev, D, compact_mod, rng, rng_c) -> dict:
    """Phase 2, compact_mask: kernel vs plain version on the card, exact,
    each line with its route and db splits. Timed at B = 512 and at a
    compaction sub-batch of 4096 tied rows (the summary's) x 2^20 rows,
    thresholds 0-6 and a tenth of the rows off; then the split shapes
    B = 1 and 77 x (2^20 + 37) at thresholds in [-1, 60], B = 77 at
    thresh = L (every real window set, no padding bit), and the long
    route (form (a)) at L = 150, timed at 4096 x 2^20."""
    timings = {}
    codes = random_db(rng, sizes.parity_rows_compact, L_SMOKE)
    n = codes.shape[0]
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    db_emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L_SMOKE, wp)
    for b, timed in ((512, "parity"), (sizes.compact_rows, "main")):
        q = mutate(rng, codes[rng.integers(0, n, b)], 6)
        th = rng.integers(0, 7, b).astype(np.int32)
        th[rng.random(b) < 0.1] = -1
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L_SMOKE)
        thresh = torch.from_numpy(th).to(dev)
        plan = compact_plan(compact_mod, b, wp, q_emb.shape[1], dev)
        compact_check(compact_mod, D, q_emb, db_emb, zc, thresh, L_SMOKE,
                      f"B={b}")
        log("kernel_parity", kernel="compact_mask", L=L_SMOKE, B=b, W=n,
            **plan, exact=True)
        timings[timed] = compact_time(sizes, compact_mod, D, q_emb, db_emb,
                                      zc, thresh, L_SMOKE, n, **plan)
    del db_emb, zc, q_emb
    n = sizes.parity_rows
    codes = random_db(rng_c, n, L_SMOKE)
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    db_emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L_SMOKE, wp)
    for b, kind in ((1, "mixed"), (77, "mixed"), (77, "all")):
        q = mutate(rng_c, codes[rng_c.integers(0, n, b)], 6)
        th = (np.full(b, L_SMOKE) if kind == "all"
              else rng_c.integers(-1, L_SMOKE + 1, b)).astype(np.int32)
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L_SMOKE)
        got = compact_check(compact_mod, D, q_emb, db_emb, zc,
                            torch.from_numpy(th).to(dev), L_SMOKE,
                            f"B={b} W={n} thresh {kind}")
        hits = row_hits(got)
        if kind == "all" and (hits != n).any():
            raise AssertionError("compact_mask at thresh = L: a row's hits "
                                 "differ from the real windows")
        log("kernel_parity", kernel="compact_mask", L=L_SMOKE, B=b, W=n,
            thresh=kind, **compact_plan(compact_mod, b, wp, q_emb.shape[1], dev),
            max_row_hits=int(hits.max()), exact=True)
    del db_emb, zc, q_emb, got
    L, b = 150, sizes.compact_rows
    codes = random_db(rng_c, sizes.parity_rows_compact, L)
    n = codes.shape[0]
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    db_emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L, wp)
    q = mutate(rng_c, codes[rng_c.integers(0, n, b)], 6)
    th = rng_c.integers(0, 7, b).astype(np.int32)
    th[rng_c.random(b) < 0.1] = -1
    q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L)
    thresh = torch.from_numpy(th).to(dev)
    plan = compact_plan(compact_mod, b, wp, q_emb.shape[1], dev)
    compact_check(compact_mod, D, q_emb, db_emb, zc, thresh, L,
                  f"L={L} B={b}")
    log("kernel_parity", kernel="compact_mask", L=L, B=b, W=n, **plan,
        exact=True)
    compact_time(sizes, compact_mod, D, q_emb, db_emb, zc, thresh, L, n,
                 **plan)
    return {"max_abs_err": 0, **timings["main"]}


def min_count_check(mc_mod, D, q_emb, emb, zc, n_valid: int, L: int,
                    shift: int, where: str) -> tuple:
    """The kernel's (key[, cnt]), with the count and without it, held
    exactly to the plain version's; returns the plain (key, cnt)."""
    for with_count in (False, True):
        got = mc_mod.min_count(q_emb, emb, zc, n_valid, L, shift, with_count)
        want = D.min_count_reference(q_emb, emb, zc, n_valid, L, shift,
                                     with_count)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        if err != 0:
            raise AssertionError(
                f"min_count kernel differs from its plain version at {where} "
                f"with_count={with_count} (max |err| {err})")
    return want


def live_plan(min2_mod, b: int, n_valid: int, ep: int, dev,
              kernel: str) -> dict:
    """The route and db splits the ``kernel`` ("min_count" or "kstats")
    wrapper launches with (``ops/min2.py:live_plan``, over the first
    n_valid rows, at the kernel's item cost)."""
    item = {"min_count": min2_mod.MIN_COUNT_ITEM_STEPS,
            "kstats": min2_mod.KSTATS_ITEM_STEPS}[kernel]
    route, splits = min2_mod.live_plan(b, n_valid, ep, min2_mod.sm_count(dev),
                                       item)
    return {"route": route, "splits": splits}


def min_count_split_cases(sizes, rng):
    """min_count's split-route shapes, each (what, L, buffer codes,
    queries, n_valid), generated lazily: the cluster's batches against
    29,321 centroids live in a 32,768-row buffer; n_valid = 37 (one
    partial tile) and 3001 in a buffer whose rows past n_valid are exact
    copies of the queries; a db of one repeated row; a db whose only
    exact match is its last live row; 63 and 64 bp; the long route at
    L = 150."""
    n_valid, wp = sizes.min_count_split_rows
    buf = random_db(rng, wp, L_SMOKE)
    for b in sizes.min_count_split_queries:
        q = mutate(rng, buf[rng.integers(0, n_valid, b)], 6)
        q[: max(1, b // 8)] = buf[rng.integers(0, n_valid, max(1, b // 8))]
        yield "cluster batch", L_SMOKE, buf, q, n_valid
    for nv in (37, 3001):
        buf = random_db(rng, 70016, L_SMOKE)
        q = mutate(rng, buf[rng.integers(0, nv, 300)], 6)
        buf[nv:nv + 300] = q
        yield "query copies past n_valid", L_SMOKE, buf, q, nv
    same = rng.integers(0, 4, (1, L_SMOKE), dtype=np.uint8)
    buf = np.repeat(same, 70016, axis=0)
    yield "one repeated row", L_SMOKE, buf, mutate(rng, buf[:77], 3), 70001
    buf = rng.integers(0, 4, (70016, L_SMOKE), dtype=np.uint8)
    q = mutate(rng, buf[[70000] * 77], 6)
    q[:38] = buf[70000]
    yield "best match the last live row", L_SMOKE, buf, q, 70001
    for L in (63, 64, 150):
        buf = random_db(rng, 9024, L)
        yield "width", L, buf, mutate(rng, buf[rng.integers(0, 8999, 300)], 6), 8999


def min_count_parity(sizes, dev, D, K, mc_mod, min2_mod, rng,
                     rng_n) -> dict:
    """Phase 2, min_count: kernel vs plain version on the card, exact,
    with and without the count: over a buffer whose rows are all live
    (the scan must stop at n_valid) at L = 3, 60, 150 and 300, then at
    the split-route shapes of ``min_count_split_cases`` (from ``rng_n``),
    each line with its route and db splits; then timed at the cluster
    path's shapes (with_count off, as the path calls it)."""
    wp = sizes.min_count_rows
    for L in (3, 60, 150, 300):
        buf = random_db(rng, wp, L) if L > 3 else rng.integers(
            0, 5, (wp, L), dtype=np.uint8)
        q = mutate(rng, buf[rng.integers(0, wp, 1000)], 6) if L > 3 else \
            buf[rng.integers(0, wp, 1000)]
        emb, zc = D.embed_db(torch.from_numpy(buf).to(dev), L, wp)
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L)
        shift = K.packing_shift(L, wp)
        plans = []
        for n_valid in (sizes.min_count_below, wp):
            min_count_check(mc_mod, D, q_emb, emb, zc, n_valid, L, shift,
                            f"L={L} n_valid={n_valid}")
            plans.append(live_plan(min2_mod, 1000, n_valid, q_emb.shape[1],
                                   dev, "min_count"))
        log("kernel_parity", kernel="min_count", L=L, B=1000, W=wp,
            n_valid=[sizes.min_count_below, wp],
            route=[p["route"] for p in plans],
            splits=[p["splits"] for p in plans], exact=True)
    for what, L, buf, q, n_valid in min_count_split_cases(sizes, rng_n):
        w = -(-buf.shape[0] // D.WP_MULTIPLE) * D.WP_MULTIPLE
        emb, zc = D.embed_db(torch.from_numpy(buf).to(dev), L, w)
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L)
        shift = K.packing_shift(L, w)
        b = q.shape[0]
        key, cnt = min_count_check(mc_mod, D, q_emb, emb, zc, n_valid, L,
                                   shift, f"{what} L={L} B={b} n_valid={n_valid}")
        log("kernel_parity", kernel="min_count", case=what, L=L, B=b,
            W=buf.shape[0], n_valid=n_valid,
            **live_plan(min2_mod, b, n_valid, q_emb.shape[1], dev,
                        "min_count"),
            min_dist=int(key.min()) >> shift, max_count=int(cnt.max()),
            exact=True)
        del emb, zc, q_emb
    timings = {}
    for b, w, which, reps in sizes.min_count_times:
        buf = random_db(rng, w, L_SMOKE)
        q = mutate(rng, buf[rng.integers(0, w, b)], 6)
        emb, zc = D.embed_db(torch.from_numpy(buf).to(dev), L_SMOKE, w)
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L_SMOKE)
        shift = K.packing_shift(L_SMOKE, w)
        got = mc_mod.min_count(q_emb, emb, zc, w, L_SMOKE, shift, False)
        want = D.min_count_reference(q_emb, emb, zc, w, L_SMOKE, shift, False)
        torch.cuda.synchronize()
        err = int((got[0].long() - want[0].long()).abs().max())
        if err != 0:
            raise AssertionError(f"min_count differs at B={b} W={w} (max |err| {err})")
        ms = time_ms(lambda: mc_mod.min_count(
            q_emb, emb, zc, w, L_SMOKE, shift, False), reps)
        plain_ms = time_ms(lambda: D.min_count_reference(
            q_emb, emb, zc, w, L_SMOKE, shift, False), max(2, reps // 5))
        dev_ms = device_ms(lambda: mc_mod.min_count(
            q_emb, emb, zc, w, L_SMOKE, shift, False), reps, "min_count")
        timings[which] = {"max_abs_err": err, **log_time(
            "min_count", L_SMOKE, b, w, ms, plain_ms,
            bound(b, w, L_SMOKE, D.embed_width(L_SMOKE), out_bytes=4 * b),
            **live_plan(min2_mod, b, w, q_emb.shape[1], dev, "min_count"),
            device_ms=dev_ms)}
    return timings["main"]


def replay_min_count(mc_mod, D, K, shapes, rng, dev,
                     reps: int = 3) -> float | None:
    """Summed device ms of min_count launches at ``shapes`` ((B, n_valid,
    buffer rows) each, with_count off, as the cluster path calls it), on
    queries mutated off a random L = 60 buffer: the profiler's device
    time of the kernels and their merges (``device_ms``) per replay of
    all the launches, over ``reps`` replays, which leaves out the host's
    launch gaps."""
    calls = []
    for b, n_valid, w in shapes:
        buf = random_db(rng, w, L_SMOKE)
        q = mutate(rng, buf[rng.integers(0, n_valid, b)], 4)
        emb, zc = D.embed_db(torch.from_numpy(buf).to(dev), L_SMOKE, w)
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L_SMOKE)
        calls.append((q_emb, emb, zc, n_valid, L_SMOKE,
                      K.packing_shift(L_SMOKE, w), False))
    return device_ms(lambda: [mc_mod.min_count(*c) for c in calls], reps,
                     "min_count")


def kstats_check(ks_mod, D, q_emb, db_emb, zc, ts, n_valid: int,
                 where: str, L: int = L_SMOKE) -> None:
    """The kernel's (cnt, mx), held exactly to the plain version's."""
    got = ks_mod.kstats(q_emb, db_emb, zc, ts, n_valid, L)
    want = D.stats_reference(q_emb, db_emb, zc, ts, n_valid, L)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"kstats kernel differs from its plain version "
                             f"at {where} (max |err| {err})")


def kstats_parity(sizes, dev, D, K, ks_mod, min2_mod, rng, rng_s) -> dict:
    """Phase 4, kstats: kernel vs plain version on the card, exact, each
    line with its route and db splits, against 2^20 + 37 real db rows in
    a buffer padded to the 64-row tile, per-row thresholds in [-1, 60]:
    at the K-mode batches of the CLI runs (B = 16384 and 4096, both
    timed; the summary keeps B = 16384), at the split shapes B = 1 and 77
    and at n_valid = 37 (one partial tile; the buffer's rows past it are
    live). Then one whole cutoff search (kmode_phase1 at K = 99: 3 passes
    and their merges) timed at B = 16384 and 4096."""
    n = sizes.kstats_rows
    codes = random_db(rng, n, L_SMOKE)
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    ep = D.embed_width(L_SMOKE)
    db_emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L_SMOKE, wp)

    def plan(b: int, n_valid: int) -> dict:
        return live_plan(min2_mod, b, n_valid, ep, dev, "kstats")

    def operands(r, b: int):
        q = mutate(r, codes[r.integers(0, n, b)], 6)
        q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L_SMOKE)
        ts = torch.from_numpy(r.integers(
            -1, L_SMOKE + 1, (K.KSTATS_PROBES, b)).astype(np.int32)).to(dev)
        return q_emb, ts

    timings = {}
    for b, which in sizes.kstats_queries:
        q_emb, ts = operands(rng, b)
        kstats_check(ks_mod, D, q_emb, db_emb, zc, ts, n, f"B={b} W={n}")
        log("kernel_parity", kernel="kstats", L=L_SMOKE, B=b, W=n, n_valid=n,
            **plan(b, n), exact=True)
        ms = time_ms(lambda: ks_mod.kstats(q_emb, db_emb, zc, ts, n, L_SMOKE),
                     sizes.reps)
        plain_ms = time_ms(lambda: D.stats_reference(q_emb, db_emb, zc, ts, n,
                                                     L_SMOKE), 2)
        bnd = bound(b, n, L_SMOKE, ep, out_bytes=4 * (K.KSTATS_PROBES + 1) * b,
                    extra_in_bytes=4 * K.KSTATS_PROBES * b)
        timings[which] = {"max_abs_err": 0, **log_time(
            "kstats", L_SMOKE, b, n, ms, plain_ms, bnd, **plan(b, n))}
        # one whole cutoff search: kstats_steps(L) passes at the real probes
        steps = K.kstats_steps(L_SMOKE)

        def search(fn):
            return D.kmode_phase1(
                lambda t: fn(q_emb, db_emb, zc, t, n, L_SMOKE), sizes.kmode_k,
                L_SMOKE + 1, n, L_SMOKE, b, dev)

        got, want = search(ks_mod.kstats), search(D.stats_reference)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"the cutoff search over the kstats kernel "
                                 f"differs from its plain version at B={b}")
        ms = time_ms(lambda: search(ks_mod.kstats), sizes.reps)
        plain_ms = time_ms(lambda: search(D.stats_reference), 1)
        log_time("kmode_phase1", L_SMOKE, b, n, ms, plain_ms,
                 (steps * bnd[0], bnd[1]), k=sizes.kmode_k, passes=steps,
                 **plan(b, n))
        del q_emb, ts
    for b, n_valid in sizes.kstats_split_shapes:
        q_emb, ts = operands(rng_s, b)
        kstats_check(ks_mod, D, q_emb, db_emb, zc, ts, n_valid,
                     f"B={b} n_valid={n_valid}")
        log("kernel_parity", kernel="kstats", L=L_SMOKE, B=b, W=n,
            n_valid=n_valid, **plan(b, n_valid), exact=True)
    return timings["main"]


def hist_plan(hist_mod, b: int, n_valid: int, L: int, dev) -> dict:
    """The hist kernel's route, db splits, query rows a block and bin
    bytes a block at a launch of this shape on this card."""
    return hist_mod.launch_plan(b, n_valid, L,
                                hist_mod.M.sm_count(dev))._asdict()


def hist_check(hist_mod, D, q_emb, db_emb, zc, n_valid: int, L: int,
               where: str) -> torch.Tensor:
    """The kernel's histogram, held exactly to the plain version's."""
    got = hist_mod.hist(q_emb, db_emb, zc, n_valid, L)
    want = D.hist_reference(q_emb, db_emb, zc, n_valid, L)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0 or int(got.sum()) != q_emb.shape[0] * n_valid:
        raise AssertionError(f"hist kernel differs from its plain version "
                             f"at {where} (max |err| {err})")
    return got


def hist_vs_search(sizes, D, K, hist_mod, ks_mod, q_emb, db_emb, zc,
                   n: int, L: int, reps: int) -> dict:
    """One K = 99 cutoff search both ways on the same operands: the
    kstats search (kstats_steps(L) passes, ``kmode_phase1``) and one
    hist pass read by ``kmode_cutoffs_from_hist``; their (eff, hits)
    must be equal. Times by CUDA events, in this call."""
    b = q_emb.shape[0]

    def search():
        return D.kmode_phase1(
            lambda t: ks_mod.kstats(q_emb, db_emb, zc, t, n, L),
            sizes.kmode_k, L + 1, n, L, b, q_emb.device)

    def by_hist():
        return D.kmode_cutoffs_from_hist(
            hist_mod.hist(q_emb, db_emb, zc, n, L), sizes.kmode_k, L + 1, n)

    if not all(torch.equal(g, w) for g, w in zip(by_hist(), search())):
        raise AssertionError(f"the histogram's cutoffs differ from the "
                             f"kstats search's at B={b}, L={L}")
    return {"kstats_search_ms": time_ms(search, reps),
            "kstats_passes": K.kstats_steps(L),
            "hist_cutoffs_ms": time_ms(by_hist, reps)}


def hist_parity(sizes, dev, D, K, hist_mod, ks_mod, rng) -> dict:
    """Phase 4, hist: kernel vs plain version on the card, exact, each
    line with its route, db splits, query rows a block and bin bytes a
    block: at the K-mode batches B = 16384 and 4096 against 2^20 + 37
    db rows (60 bp), timed beside one kstats pass's bound and beside the
    whole K = 99 kstats search and the histogram's own cutoffs at the
    same shape (``hist_vs_search``); at B = 1 and 77 (many splits), at
    n_valid = 37 (one partial tile; the buffer's rows past it live), on
    a db of one repeated row (every row in one bin), and at L = 3 and
    64. Returns the B = 16384 timing."""
    n = sizes.kstats_rows
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    ep = D.embed_width(L_SMOKE)
    codes = random_db(rng, n, L_SMOKE)
    db_emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L_SMOKE, wp)

    def queries(b: int, L: int = L_SMOKE, src=codes):
        q = mutate(rng, src[rng.integers(0, src.shape[0], b)], 6)
        return D.expand_embed_query(torch.from_numpy(q).to(dev), L)

    timings = {}
    for b, which in sizes.kstats_queries:
        q_emb = queries(b)
        hist_check(hist_mod, D, q_emb, db_emb, zc, n, L_SMOKE,
                   f"B={b} W={n}")
        plan = hist_plan(hist_mod, b, n, L_SMOKE, dev)
        log("kernel_parity", kernel="hist", L=L_SMOKE, B=b, W=n, n_valid=n,
            **plan, exact=True)
        ms = time_ms(lambda: hist_mod.hist(q_emb, db_emb, zc, n, L_SMOKE),
                     sizes.reps)
        plain_ms = time_ms(lambda: D.hist_reference(q_emb, db_emb, zc, n,
                                                    L_SMOKE), 1)
        bnd = bound(b, n, L_SMOKE, ep, out_bytes=4 * (L_SMOKE + 1) * b)
        timings[which] = {"max_abs_err": 0, **log_time(
            "hist", L_SMOKE, b, n, ms, plain_ms, bnd, **plan,
            **hist_vs_search(sizes, D, K, hist_mod, ks_mod, q_emb, db_emb,
                             zc, n, L_SMOKE, sizes.reps))}
        del q_emb
    rep = np.repeat(codes[:1], n, axis=0)
    rep_emb, rep_zc = D.embed_db(torch.from_numpy(rep).to(dev), L_SMOKE, wp)
    for b, n_valid, db in sizes.hist_split_shapes:
        emb, z = (db_emb, zc) if db == "random" else (rep_emb, rep_zc)
        q_emb = queries(b, src=codes if db == "random" else codes[:64])
        got = hist_check(hist_mod, D, q_emb, emb, z, n_valid, L_SMOKE,
                         f"B={b} n_valid={n_valid} db={db}")
        if db == "repeated" and not bool((got.max(dim=1).values
                                          == n_valid).all()):
            raise AssertionError("hist: a repeated-row db's rows are not "
                                 "in one bin")
        log("kernel_parity", kernel="hist", L=L_SMOKE, B=b, W=n,
            n_valid=n_valid, db=db,
            **hist_plan(hist_mod, b, n_valid, L_SMOKE, dev), exact=True)
    del rep_emb, rep_zc, db_emb, zc
    for b, L in sizes.hist_widths:
        nw = 70001
        src = random_db(rng, nw, L)
        emb, z = D.embed_db(torch.from_numpy(src).to(dev), L,
                            -(-nw // D.WP_MULTIPLE) * D.WP_MULTIPLE)
        q_emb = queries(b, L, src)
        hist_check(hist_mod, D, q_emb, emb, z, nw, L, f"B={b} L={L}")
        log("kernel_parity", kernel="hist", L=L, B=b, W=nw, n_valid=nw,
            **hist_plan(hist_mod, b, nw, L, dev), exact=True)
    torch.cuda.empty_cache()
    return timings["main"]


def kmode_compact_parity(sizes, dev, D, K, ks_mod, compact_mod, hitops,
                         codes, rng) -> None:
    """Phase 4, compact_mask at the K-mode compaction's shape: one
    dispatch of mask_row_cap(2^20) = 8192 reads against phase 3's db, at
    each read's K = 99 cutoff (from the cutoff search over the kstats
    kernel, already held to its plain version), exact against the plain
    version and timed; the mask's per-row hit counts must equal the
    search's."""
    n = codes.shape[0]
    b = hitops.mask_row_cap(n)
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    db_emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L_SMOKE, wp)
    q = mutate(rng, codes[rng.integers(0, n, b)], 6)
    q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L_SMOKE)
    thresh, hits = D.kmode_phase1(
        lambda ts: ks_mod.kstats(q_emb, db_emb, zc, ts, n, L_SMOKE),
        sizes.kmode_k, L_SMOKE + 1, n, L_SMOKE, b, dev)
    got = compact_check(compact_mod, D, q_emb, db_emb, zc, thresh, L_SMOKE,
                        "the K-mode shape")
    if not torch.equal(D.extract_mask_hits(got)[2].to(torch.int32), hits):
        raise AssertionError("K-mode compaction counts differ from the "
                             "cutoff search's")
    th = thresh.cpu().numpy()
    plan = compact_plan(compact_mod, b, wp, q_emb.shape[1], dev)
    log("kernel_parity", kernel="compact_mask", L=L_SMOKE, B=b, W=n,
        k=sizes.kmode_k, thresh_min=int(th.min()),
        thresh_median=float(np.median(th)), thresh_max=int(th.max()),
        hits=int(hits.sum()), **plan, exact=True)
    compact_time(sizes, compact_mod, D, q_emb, db_emb, zc, thresh, L_SMOKE,
                 n, k=sizes.kmode_k, **plan)


def write_fasta(path: str, codes: np.ndarray, prefix: str) -> None:
    seqs = np.frombuffer(b"ACGTN", np.uint8)[codes]
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{prefix}{i}\n{s.tobytes().decode()}\n")


def brute_force_lines(codes: np.ndarray, q: np.ndarray, qnum: int,
                      max_div: int, codes_t: torch.Tensor | None = None
                      ) -> list[str]:
    """The reference best-hit lines of one query (lib.rs:306-313); the
    distances by code comparison on the card when ``codes_t``, a copy
    of ``codes`` there, is given, else on the host."""
    L = codes.shape[1]
    if codes_t is not None:
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(codes_t.device)
        dist = (codes_t != qt).sum(dim=1, dtype=torch.int32).cpu().numpy()
    else:
        match = np.zeros(codes.shape[0], np.int32)
        for c in range(L):
            match += codes[:, c] == q[c]
        dist = L - match
    mind = int(dist.min())
    if mind > max_div:
        return []
    return [f"{qnum}\t{i}\t{mind}\t{np.frombuffer(b'ACGTN', np.uint8)[codes[i]].tobytes().decode()}"
            for i in np.nonzero(dist == mind)[0]]


def cli_query(cli, query_mod, argv: list[str]):
    """Run ``query`` through the CLI: (exit code, wall seconds, the stage
    timers of the engine's run)."""
    captured = []
    run_query = query_mod.query

    def spy(*a, **kw):
        captured.append(run_query(*a, **kw))
        return captured[-1]

    query_mod.query = spy
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        query_mod.query = run_query
    return rc, wall, captured[0] if captured else None


class HostSpies:
    """Counts the calls of the native parse (``parse_buffer``), emit
    (``format_hits_tsv_codes``) and dedup (``dedup_filter``) while
    active, the way ``cluster_cli`` records min_count's shapes."""

    def __init__(self):
        from smafa_tpu_torch import native
        from smafa_tpu_torch.native import ingest

        self._targets = [(ingest, "parse_buffer"),
                         (ingest, "format_hits_tsv_codes"),
                         (native.load(), "dedup_filter")]
        self.counts: dict[str, int] = {}
        self._saved: list = []

    def __enter__(self) -> "HostSpies":
        self.counts = {name: 0 for _, name in self._targets}
        for obj, name in self._targets:
            fn = getattr(obj, name)
            self._saved.append((obj, name, fn))

            def spy(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] += 1
                return _fn(*a, **kw)

            setattr(obj, name, spy)
        return self

    def __exit__(self, *exc) -> None:
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)
        self._saved = []

    def require(self, phase: str, *names: str) -> None:
        missing = [n for n in names if self.counts[n] <= 0]
        if missing:
            raise AssertionError(f"{phase}: {missing} never called, so that "
                                 "stage did not run natively")


def end_to_end(sizes, cli, query_mod, min2_mod, compact_mod, rng,
               tmp: str) -> tuple[dict, np.ndarray, str]:
    """Phase 3: makedb + best-hit query through the CLI. The db, the reads
    and the output stay in ``tmp`` for the K-mode, host parity and resume
    phases; returns (result, db codes, db path), the result with the
    reads' and the output's paths and the emitted hit arrays."""
    n, nq, max_div = sizes.db_rows, sizes.queries, 5
    codes = random_db(rng, n, L_SMOKE)
    src = rng.integers(0, n, nq)
    q = mutate(rng, codes[src], 6)
    db_fa, q_fa = os.path.join(tmp, "db.fna"), os.path.join(tmp, "q.fna")
    db, out = os.path.join(tmp, "db.native"), os.path.join(tmp, "hits.tsv")
    write_fasta(db_fa, codes, "s")
    write_fasta(q_fa, q, "r")
    min2_mod.launches = 0
    compact_mod.launches = 0
    t0 = time.perf_counter()
    rc_db = cli.main(["makedb", "-i", db_fa, "-d", db, "--format", "native",
                      "--quiet"])
    t1 = time.perf_counter()
    # the hits of each emit, replayed by the host parity phase
    emitted, run_emit = [], query_mod._emit_bulk

    def emit_spy(stream, qnums, subj, d, db_):
        emitted.append((np.array(qnums), np.array(subj), np.array(d),
                        types.SimpleNamespace(windows=db_.windows,
                                              seq_len=db_.seq_len)))
        return run_emit(stream, qnums, subj, d, db_)

    query_mod._emit_bulk = emit_spy
    min2_mod.launches = 0
    compact_mod.launches = 0
    try:
        with HostSpies() as spies:
            rc_q, wall, timers = cli_query(cli, query_mod, [
                "query", "-d", db, "-q", q_fa, "--max-divergence",
                str(max_div), "-o", out, "--quiet"])
    finally:
        query_mod._emit_bulk = run_emit
    launches = {"min2": min2_mod.launches,
                "compact_mask": compact_mod.launches}
    if rc_db != 0 or rc_q != 0:
        raise AssertionError(f"CLI failed: makedb rc={rc_db}, query rc={rc_q}")
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"the {name} kernel never launched on the main path")
    spies.require("query smoke", "parse_buffer", "format_hits_tsv_codes")
    with open(out) as f:
        lines = f.read().splitlines()
    os.remove(db_fa)
    by_q: dict[int, list[str]] = {}
    for line in lines:
        by_q.setdefault(int(line.split("\t", 1)[0]), []).append(line)
    # Every read lies within its number of substitutions of its source.
    to_src = (q != codes[src]).sum(axis=1)
    for i in np.nonzero(to_src <= max_div)[0]:
        got = by_q.get(int(i))
        if not got or int(got[0].split("\t")[2]) > to_src[i]:
            raise AssertionError(f"query {i}: best hit missing or worse than "
                                 f"its source window at distance {to_src[i]}")
    sample = rng.choice(nq, size=min(sizes.sample, nq), replace=False)
    codes_t = torch.from_numpy(codes).cuda()
    for i in sorted(sample.tolist()):
        want = brute_force_lines(codes, q[i], i, max_div, codes_t)
        if by_q.get(i, []) != want:
            raise AssertionError(f"query {i}: lines differ from brute force:\n"
                                 f"got {by_q.get(i, [])[:3]}\nwant {want[:3]}")
    # Host seconds spent launching and waiting for the device; device work
    # that overlaps the next batch's parse is not in it, so the wall-time
    # rate is the end-to-end figure.
    scan_s = timers.seconds.get("dispatch", 0.0) + timers.seconds.get("scan", 0.0)
    res = {"makedb_s": t1 - t0, "query_wall_s": wall,
           "queries_per_s": nq / wall, "scan_s": scan_s,
           "comparisons_per_s_scan": nq * n / scan_s,
           "comparisons_per_s_wall": nq * n / wall,
           "stage_s": timers.seconds, "hit_lines": len(lines),
           "sampled_exact": int(sample.size), "launches": launches,
           "host_calls": spies.counts}
    log("end_to_end", db_rows=n, queries=nq, **res)
    res.update(reads=q_fa, output=out, emitted=emitted)
    return res, codes, db


def brute_force_kmode(codes_t: np.ndarray, codes: np.ndarray, q: np.ndarray,
                      qnum: int, k: int, max_div: int | None,
                      limit: int | None) -> list[str]:
    """The reference K-mode lines of one query (lib.rs:241-295): every
    window at distance <= min(K-th smallest distance, max_div), the row
    max when K exceeds the windows, in (distance, index) order, cutoff
    ties included; a run of consecutive hits with one sequence prints at
    most ``limit`` lines. ``codes_t`` is the db transposed ([L, W])."""
    match = np.zeros(codes_t.shape[1], np.uint8)
    for c in range(codes_t.shape[0]):
        match += codes_t[c] == q[c]
    dist = codes_t.shape[0] - match.astype(np.int32)
    cutoff = dist.max() if k > dist.size else np.partition(dist, k - 1)[k - 1]
    eff = cutoff if max_div is None else min(cutoff, max_div)
    sel = np.nonzero(dist <= eff)[0]
    lines, last = [], None
    for i in sel[np.lexsort((sel, dist[sel]))]:
        s = np.frombuffer(b"ACGTN", np.uint8)[codes[i]].tobytes().decode()
        if limit is not None:
            if last is not None and last[0] == s:
                if last[1] >= limit:
                    continue
                last = (s, last[1] + 1)
            else:
                last = (s, 1)
        lines.append(f"{qnum}\t{i}\t{dist[i]}\t{s}")
    return lines


def kmode_end_to_end(sizes, cli, query_mod, K, ks_mod, compact_mod,
                     hist_mod, codes, db, tmp, rng) -> dict:
    """Phase 4, K-mode query through the CLI on phase 3's db: each run's
    kernel counts set to 0 just before it and read just after; sampled
    reads checked against a brute force; the output file deleted. Each
    run again with SMAFA_TPU_KMODE_HIST=1 (``<run>_hist``): its sha256
    equal to the run's, one hist launch a batch and no kstats."""
    n = codes.shape[0]
    codes_t = np.ascontiguousarray(codes.T)
    results = {}
    for name, nq, max_div, limit, batch in sizes.kmode_runs:
        q = mutate(rng, codes[rng.integers(0, n, nq)], 6)
        q_fa, out = os.path.join(tmp, "kq.fna"), os.path.join(tmp, "khits.tsv")
        write_fasta(q_fa, q, "r")
        argv = ["query", "-d", db, "-q", q_fa, "--max-num-hits",
                str(sizes.kmode_k), "-o", out, "--quiet"]
        if max_div is not None:
            argv += ["--max-divergence", str(max_div)]
        if limit is not None:
            argv += ["--limit-per-sequence", str(limit)]
        if batch is not None:
            argv += ["--batch-size", str(batch)]
        ks_mod.launches = compact_mod.launches = 0
        with HostSpies() as spies:
            rc, wall, timers = cli_query(cli, query_mod, argv)
        launches = {"kstats": ks_mod.launches,
                    "compact_mask": compact_mod.launches}
        if limit is None:  # emitted in bulk, natively
            spies.require(f"K-mode run {name}", "format_hits_tsv_codes")
        batches = -(-nq // (batch or sizes.main_batch))
        if rc != 0:
            raise AssertionError(f"K-mode run {name}: query rc={rc}")
        if (launches["kstats"] != K.kstats_steps(L_SMOKE) * batches
                or launches["compact_mask"] < 1):
            raise AssertionError(f"K-mode run {name}: launches {launches} "
                                 f"for {batches} batch(es)")
        sha, _ = file_digest(out)
        out_h = os.path.join(tmp, "khits_hist.tsv")
        ks_mod.launches = compact_mod.launches = hist_mod.launches = 0
        os.environ[KMODE_HIST] = "1"
        try:
            rc_h, wall_h, timers_h = cli_query(
                cli, query_mod, [out_h if a == out else a for a in argv])
        finally:
            del os.environ[KMODE_HIST]
        launches_h = {"hist": hist_mod.launches, "kstats": ks_mod.launches,
                      "compact_mask": compact_mod.launches}
        sha_h, _ = file_digest(out_h)
        os.remove(out_h)
        log("kmode_end_to_end", run=f"{name}_hist", db_rows=n, reads=nq,
            batches=batches, wall_s=wall_h, reads_per_s=nq / wall_h,
            stage_s=timers_h.seconds, launches=launches_h, sha256=sha_h,
            sha256_equal=sha_h == sha)
        if (rc_h != 0 or sha_h != sha or launches_h["hist"] != batches
                or launches_h["kstats"] != 0):
            raise AssertionError(f"K-mode run {name} with {KMODE_HIST}=1: "
                                 f"rc={rc_h}, sha256 equal {sha_h == sha}, "
                                 f"launches {launches_h}")
        sample = set(rng.choice(nq, size=sizes.kmode_sample,
                                replace=False).tolist())
        by_q: dict[int, list[str]] = {}
        n_lines = 0
        with open(out) as f:
            for line in f:
                n_lines += 1
                qnum = int(line[:line.index("\t")])
                if qnum in sample:
                    by_q.setdefault(qnum, []).append(line.rstrip("\n"))
        if name == "b":  # phase 8 replays run (b) in the stream layout
            os.replace(q_fa, q_fa.replace(".fna", "_b.fna"))
            os.replace(out, out.replace(".tsv", "_b.tsv"))
        else:
            os.remove(out)
            os.remove(q_fa)
        for i in sorted(sample):
            want = brute_force_kmode(codes_t, codes, q[i], i, sizes.kmode_k,
                                     max_div, limit)
            if by_q.get(i, []) != want:
                raise AssertionError(
                    f"K-mode run {name}, query {i}: lines differ from brute "
                    f"force:\ngot {by_q.get(i, [])[:3]}\nwant {want[:3]}")
        res = {"reads": nq, "k": sizes.kmode_k, "max_divergence": max_div,
               "limit_per_sequence": limit, "batches": batches,
               "wall_s": wall, "reads_per_s": nq / wall,
               "hit_lines": n_lines, "stage_s": timers.seconds,
               "sampled_exact": len(sample), "launches": launches,
               "host_calls": spies.counts, "sha256": sha,
               "hist_launches": launches_h["hist"]}
        log("kmode_end_to_end", run=name, db_rows=n, **res)
        if name == "b":
            res.update(reads_file=q_fa.replace(".fna", "_b.fna"),
                       output_file=out.replace(".tsv", "_b.tsv"),
                       flags=argv[5:7] + argv[10:])  # less -o, --quiet
        results[name] = res
    return results


def load_cluster_bench():
    """tools/cluster_bench.py as a module (its make_input is pure numpy)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "cluster_bench.py")
    spec = importlib.util.spec_from_file_location("cluster_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fasta_codes(path: str, L: int) -> np.ndarray:
    """ASCII rows [n, L] of a one-line-per-sequence FASTA."""
    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::2]
    return np.frombuffer(b"".join(seqs), np.uint8).reshape(-1, L)


def greedy_oracle(records: np.ndarray, cents: np.ndarray, cent_line: np.ndarray,
                  max_div: int, j: int) -> bytes:
    """The reference's centroid for output line j (cluster.rs:51-74):
    the lowest-index centroid created before it at the min distance, or
    the record itself when that minimum exceeds max_div."""
    before = cents[cent_line < j]
    if before.shape[0]:
        dist = (before != records[j]).sum(axis=1)
        k = int(dist.argmin())
        if dist[k] <= max_div:
            return before[k].tobytes()
    return records[j].tobytes()


def cluster_cli(cli, cluster_mod, argv: list[str]):
    """Run ``cluster`` through the CLI: (exit code, wall seconds, the
    stage timers of the engine's run, the (B, n_valid, buffer rows) of
    each min_count call it made)."""
    captured, shapes = [], []
    run_cluster, run_mc = cluster_mod.cluster, cluster_mod.min_count

    def spy(*a, **kw):
        captured.append(run_cluster(*a, **kw))
        return captured[-1]

    def mc_spy(q_emb, db_emb, zc, n_valid, *a, **kw):
        shapes.append((q_emb.shape[0], n_valid, db_emb.shape[0]))
        return run_mc(q_emb, db_emb, zc, n_valid, *a, **kw)

    cluster_mod.cluster, cluster_mod.min_count = spy, mc_spy
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        cluster_mod.cluster, cluster_mod.min_count = run_cluster, run_mc
    return rc, wall, captured[0] if captured else None, shapes


def cluster_lines(text: bytes, L: int):
    """(sha256, record rows, centroid rows, distinct centroids) of a
    cluster output of L bp records."""
    import hashlib

    rows = np.frombuffer(text, np.uint8).reshape(-1, 2 * L + 2)
    cent_of = rows[:, L + 1:2 * L + 1]
    n_cent = int(np.unique(cent_of.view(np.dtype((np.void, L)))).shape[0])
    return hashlib.sha256(text).hexdigest(), rows[:, :L], cent_of, n_cent


def cluster_end_to_end(sizes, cli, cluster_mod, mc_mod, D, K, dev, rng,
                       rng_r, tmp: str) -> tuple[dict, str]:
    """Phase 5: cluster 1M records through the CLI, then count. A spy on
    the engine's min_count records the (B, n_valid, buffer rows) of every
    launch; after the run they are replayed (``replay_min_count``, data
    from ``rng_r``) for the kernel's summed device ms. The input stays
    in ``tmp`` for the host parity and resume phases; returns (result,
    input path)."""
    import contextlib
    import io

    bench = load_cluster_bench()
    L, max_div = L_SMOKE, sizes.cluster_div
    inp, out = os.path.join(tmp, "in.fna"), os.path.join(tmp, "clusters.tsv")
    t0 = time.perf_counter()
    bench.make_input(inp, sizes.cluster_records, 4000, L, 4, 0)
    gen_s = time.perf_counter() - t0
    mc_mod.launches = 0
    with HostSpies() as spies:
        rc, wall, timers, shapes = cluster_cli(cli, cluster_mod, [
            "cluster", "-i", inp, "-d", str(max_div), "-o", out, "--quiet"])
    launches = mc_mod.launches
    if rc != 0:
        raise AssertionError(f"cluster CLI failed: rc={rc}")
    if launches <= 0:
        raise AssertionError("the min_count kernel never launched on the cluster path")
    spies.require("cluster 1M", "parse_buffer", "dedup_filter")
    with open(out, "rb") as f:
        text = f.read()
    os.remove(out)
    buf = io.StringIO()
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc_count = cli.main(["count", "-i", inp, "--quiet"])
    count_s = time.perf_counter() - t2
    want_count = json.dumps([{"path": inp, "num_reads": sizes.cluster_records,
                              "num_bases": sizes.cluster_records * L}],
                            separators=(",", ":")) + "\n"
    if rc_count != 0 or buf.getvalue() != want_count:
        raise AssertionError(f"count: rc={rc_count}, printed {buf.getvalue()!r}")
    inputs = fasta_codes(inp, L)
    sha, records, cent_of, n_cent = cluster_lines(text, L)
    n_distinct = np.unique(inputs.view(np.dtype((np.void, L)))).shape[0]
    is_cent = (records == cent_of).all(axis=1)
    cent_line = np.nonzero(is_cent)[0]
    cents = records[cent_line]
    far = int(((records != cent_of).sum(axis=1) > max_div).sum())
    sample = np.sort(rng.choice(records.shape[0], size=sizes.sample, replace=False))
    bad = [int(j) for j in sample
           if greedy_oracle(records, cents, cent_line, max_div, int(j))
           != cent_of[j].tobytes()]
    mc_ms = replay_min_count(mc_mod, D, K, shapes, rng_r, dev)
    res = {"records": sizes.cluster_records, "divergence": max_div,
           "gen_s": gen_s, "wall_s": wall,
           "records_per_s": sizes.cluster_records / wall,
           "stage_s": timers.seconds,
           "comparisons": timers.counters.get("comparisons", 0),
           "lines": int(records.shape[0]), "distinct_records": int(n_distinct),
           "centroids": n_cent, "centroids_as_own_line": int(cent_line.size),
           "far_lines": far, "sampled_oracle": int(sample.size),
           "oracle_mismatches": bad[:5], "sha256": sha,
           "sha256_equals_smafa_tpu": sha == CLUSTER_SHA256,
           "count_s": count_s, "launches": {"min_count": launches},
           "host_calls": spies.counts,
           "min_count_shapes": shapes, "min_count_device_ms": mc_ms,
           "min_count_share_of_wall": mc_ms and mc_ms / 1e3 / wall}
    log("cluster_end_to_end", **res)
    if (records.shape[0] != n_distinct or far or n_cent != CLUSTER_CENTROIDS
            or cent_line.size != n_cent or bad or sha != CLUSTER_SHA256):
        raise AssertionError(
            f"cluster output wrong: {records.shape[0]} lines for {n_distinct} "
            f"distinct records, {far} lines beyond {max_div}, {n_cent} "
            f"centroids (want {CLUSTER_CENTROIDS}), oracle mismatches at "
            f"{bad[:5]}, sha256 {sha}")
    return res, inp


def with_and_without_native(fn):
    """(fn()'s result natively, its seconds, its result under
    SMAFA_TPU_NO_NATIVE=1, its seconds), in this process."""
    t0 = time.perf_counter()
    native = fn()
    t1 = time.perf_counter()
    saved = os.environ.get("SMAFA_TPU_NO_NATIVE")
    os.environ["SMAFA_TPU_NO_NATIVE"] = "1"
    try:
        plain = fn()
    finally:
        if saved is None:
            del os.environ["SMAFA_TPU_NO_NATIVE"]
        else:
            os.environ["SMAFA_TPU_NO_NATIVE"] = saved
    return native, t1 - t0, plain, time.perf_counter() - t1


def host_parity(sizes, query_mod, cluster_mod, e2e: dict, cluster_inp: str,
                codes: np.ndarray) -> dict:
    """Phase 6: the native host runtime against its pure-Python paths on
    the same data, both timed; any difference fails the run."""
    import io

    from smafa_tpu_torch.core.windowset import WindowSet
    from smafa_tpu_torch.io import fastx, postcard

    def batches(path, batch_size):
        def run():
            ids, raws, blocks = [], [], []
            for i, r, c in fastx.read_encoded_batches(path, batch_size):
                ids += i
                raws += r
                blocks.append(c)
            return ids, raws, np.concatenate(blocks)
        return run

    res = {}
    # each at the batch size its engine reads at (the cluster's ceiling)
    for name, path, bs in (("read_query_smoke", e2e["reads"], sizes.main_batch),
                           ("read_cluster_1m", cluster_inp,
                            cluster_mod._adaptive_max())):
        nat, nat_s, plain, plain_s = with_and_without_native(batches(path, bs))
        same = (nat[0] == plain[0] and nat[1] == plain[1]
                and np.array_equal(nat[2], plain[2]))
        res[name] = {"records": len(nat[0]), "batch": bs, "native_s": nat_s,
                     "plain_s": plain_s, "equal": same}

    def emit():
        raw = io.BytesIO()
        text = io.TextIOWrapper(raw, encoding="utf-8", newline="")
        for qnums, subj, d, db in e2e["emitted"]:
            query_mod._emit_bulk(text, qnums, subj, d, db)
        text.flush()
        return raw.getvalue()

    nat, nat_s, plain, plain_s = with_and_without_native(emit)
    with open(e2e["output"], "rb") as f:
        written = f.read()
    res["emit_query_smoke"] = {"bytes": len(nat), "native_s": nat_s,
                               "plain_s": plain_s,
                               "equal": nat == plain == written}
    ws = WindowSet.from_matrix(codes, 2)
    nat, nat_s, plain, plain_s = with_and_without_native(
        lambda: postcard.dumps(ws))
    res["postcard_dumps"] = {"rows": len(ws), "bytes": len(nat),
                             "native_s": nat_s, "plain_s": plain_s,
                             "equal": nat == plain}
    back, back_s, back_p, back_p_s = with_and_without_native(
        lambda: postcard.loads(nat).codes)
    res["postcard_loads"] = {"rows": len(ws), "native_s": back_s,
                             "plain_s": back_p_s,
                             "equal": bool(np.array_equal(back, codes)
                                           and np.array_equal(back_p, codes))}
    log("host_parity", **res)
    bad = [k for k, v in res.items() if not v["equal"]]
    if bad:
        raise AssertionError(f"native and plain host paths differ: {bad}")
    return res


def cluster_crash_point(cluster_mod, n: int) -> int:
    """The write at which a cluster of n distinct-rich records crashes
    just past half: one write per batch, on the adaptive schedule."""
    target, cap = cluster_mod.DEFAULT_BATCH, cluster_mod._adaptive_max()
    done, writes = 0, 0
    while done < n // 2:
        done += target
        writes += 1
        target = min(target * 2, cap)
    return writes + 1


def resume_phase(sizes, cli, query_mod, cluster_mod, dev, e2e: dict, db: str,
                 cluster_inp: str, tmp: str) -> dict:
    """Phase 7: crash the query smoke and cluster 1M through the engine,
    resume each through the CLI, and hold the output to the straight
    run's."""
    from smafa_tpu_torch.utils.testing import CrashError, CrashyFile

    def crash(run, out_path, fail_at):
        t0 = time.perf_counter()
        with open(out_path, "w") as f:
            try:
                run(CrashyFile(f, fail_at=fail_at))
            except CrashError:
                return time.perf_counter() - t0
        raise AssertionError(f"no crash at write {fail_at}")

    st, out = os.path.join(tmp, "q_state.json"), os.path.join(tmp, "q_resumed.tsv")
    crash_s = crash(lambda f: query_mod.query(
        db, e2e["reads"], dev, max_divergence=5, out=f, resume_state=st),
        out, 2)
    with open(st) as f:
        done = json.load(f)["done"]
    rc, wall, timers = cli_query(cli, query_mod, [
        "query", "-d", db, "-q", e2e["reads"], "--max-divergence", "5",
        "-o", out, "--resume-state", st, "--quiet"])
    with open(out, "rb") as f, open(e2e["output"], "rb") as g:
        same = f.read() == g.read()
    res = {"query": {"crashed_s": crash_s, "done_at_crash": done,
                     "resumed_wall_s": wall, "rc": rc,
                     "stage_s": timers and timers.seconds,
                     "bytes_equal": same}}
    if rc != 0 or not same or done != sizes.main_batch:
        log("resume", **res)
        raise AssertionError(f"query resume: rc={rc}, done at crash {done}, "
                             f"bytes equal {same}")
    for path in (st, out):
        os.remove(path)

    n, max_div = sizes.cluster_records, sizes.cluster_div
    st, out = os.path.join(tmp, "c_state.json"), os.path.join(tmp, "c_resumed.tsv")
    fail_at = cluster_crash_point(cluster_mod, n)
    crash_s = crash(lambda f: cluster_mod.cluster(
        cluster_inp, max_div, dev, out=f, resume_state=st), out, fail_at)
    with open(st) as f:
        state = json.load(f)
    rc, wall, timers, _ = cluster_cli(cli, cluster_mod, [
        "cluster", "-i", cluster_inp, "-d", str(max_div), "-o", out,
        "--resume-state", st, "--quiet"])
    with open(out, "rb") as f:
        sha, _, _, n_cent = cluster_lines(f.read(), L_SMOKE)
    res["cluster"] = {"crash_at_write": fail_at, "crashed_s": crash_s,
                      "done_at_crash": state["done"],
                      "centroids_at_crash": state["n_centroids"],
                      "resumed_wall_s": wall, "rc": rc,
                      "resume_prefix_s": timers and timers.seconds.get(
                          "resume-prefix"),
                      "stage_s": timers and timers.seconds,
                      "sha256": sha, "centroids": n_cent,
                      "sha256_equals_smafa_tpu": sha == CLUSTER_SHA256}
    log("resume", **res)
    if (rc != 0 or sha != CLUSTER_SHA256 or n_cent != CLUSTER_CENTROIDS
            or not 0.4 * n <= state["done"] <= 0.6 * n):
        raise AssertionError(f"cluster resume: rc={rc}, done at crash "
                             f"{state['done']}, {n_cent} centroids, sha256 {sha}")
    for path in (st, st + ".centroids.npy", out):
        os.remove(path)
    return res


# Phase 8: 4 slabs of 2^18 rows over phase 3's 2^20-row db (a); the
# full-size db past the 31-bit key budget (b).
STREAM_SLAB_BYTES_A = (1 << 18) * L_SMOKE
STREAM_ROWS = (1 << 25) + (1 << 20)
STREAM_VARS = ("SMAFA_TPU_LAYOUT", "SMAFA_TPU_SLAB_BYTES",
               "SMAFA_TPU_SLAB_RESIDENT", "SMAFA_TPU_HBM_BYTES", KMODE_HIST)


class StreamRun:
    """While active: the layout variables set to ``env`` (the others
    unset), the "smafa" logger's records kept in ``lines`` and not
    printed, and each runner ``select.make_runner`` builds kept in
    ``runners``."""

    def __init__(self, select_mod, env: dict):
        import logging

        self._select, self._env = select_mod, env
        self._logger = logging.getLogger("smafa")
        self.lines: list[str] = []
        self.runners: list = []

    def __enter__(self) -> "StreamRun":
        import logging

        self._saved_env = {v: os.environ.pop(v, None) for v in STREAM_VARS}
        os.environ.update(self._env)
        lines = self.lines

        class Keep(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        self._handler = Keep()
        self._saved_log = (self._logger.level, self._logger.propagate)
        self._logger.setLevel(logging.DEBUG)
        self._logger.propagate = False
        self._logger.addHandler(self._handler)
        self._make = self._select.make_runner

        def spy(*a, **kw):
            self.runners.append(self._make(*a, **kw))
            return self.runners[-1]

        self._select.make_runner = spy
        return self

    def __exit__(self, *exc) -> None:
        self._select.make_runner = self._make
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._saved_log[0])
        self._logger.propagate = self._saved_log[1]
        for v, val in self._saved_env.items():
            os.environ.pop(v, None)
            if val is not None:
                os.environ[v] = val


def file_digest(path: str) -> tuple[str, int]:
    """(sha256, line count) of a file, read in 64 MiB chunks."""
    import hashlib

    h, lines = hashlib.sha256(), 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            h.update(chunk)
            lines += chunk.count(b"\n")
    return h.hexdigest(), lines


def stream_query(cli, query_mod, select_mod, mods: dict, argv: list[str],
                 env: dict, nq: int, n: int, card: str) -> dict:
    """One query through the CLI in the stream layout's setting ``env``:
    the kernels' counts set to 0 just before and read just after; the
    runner's layout, tier, slab plan and upload seconds beside the wall,
    stages and rates."""
    for mod in mods.values():
        mod.launches = 0
    with StreamRun(select_mod, env) as sr:
        rc, wall, timers = cli_query(cli, query_mod, argv)
    launches = {name: mod.launches for name, mod in mods.items()}
    if rc != 0 or len(sr.runners) != 1:
        raise AssertionError(f"stream: rc={rc}, runners {sr.runners}, "
                             f"log {sr.lines[-3:]}")
    r = sr.runners[0]
    stages = timers.seconds
    scan_s = stages.get("dispatch", 0.0) + stages.get("scan", 0.0)
    return {"rc": rc, "layout": type(r).__name__,
            "tier": getattr(r, "tier", None),
            "n_slabs": getattr(r, "n_slabs", None),
            "slab_rows": getattr(r, "slab_rows", None),
            "log": [line for line in sr.lines if "layout" in line],
            "wall_s": wall, "stage_s": stages,
            "setup_s": wall - sum(stages.values()),
            "reads_per_s": nq / wall, "scan_s": scan_s,
            "comparisons_per_s_scan": nq * n / scan_s,
            "h2d_s": r.h2d_seconds() if hasattr(r, "h2d_seconds") else None,
            "h2d_bytes": getattr(r, "h2d_bytes", None),
            "fill_s": getattr(r, "fill_s", None),
            "launches": launches, "card": card}


def stream_parity(sizes, cli, query_mod, select_mod, mods, e2e: dict,
                  kmode: dict, db: str, tmp: str, card: str) -> None:
    """Phase 8 (a): the query smoke's best-hit run and K-mode run (b)
    again, SMAFA_TPU_LAYOUT=stream in 4 slabs, the resident tier then the
    streaming one: their outputs byte-equal to phases 3 and 4's; min2
    once per slab per batch, kstats 3 per slab per K-mode batch."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "stream_a.tsv")
    runs = [("best", e2e["reads"], ["--max-divergence", "5"],
             e2e["output"], sizes.queries),
            ("kmode_b", kmode["b"]["reads_file"], kmode["b"]["flags"],
             kmode["b"]["output_file"], kmode["b"]["reads"])]
    for resident in ("1", "0"):
        for name, reads, flags, want, nq in runs:
            env = {"SMAFA_TPU_LAYOUT": "stream",
                   "SMAFA_TPU_SLAB_BYTES": str(STREAM_SLAB_BYTES_A),
                   "SMAFA_TPU_SLAB_RESIDENT": resident}
            res = stream_query(cli, query_mod, select_mod, mods,
                               ["query", "-d", db, "-q", reads, *flags,
                                "-o", out, "--quiet"], env, nq, 1 << 20, card)
            with open(out, "rb") as f, open(want, "rb") as g:
                res["bytes_equal"] = f.read() == g.read()
            os.remove(out)
            n_slabs = res["n_slabs"]
            batches = -(-nq // 65536)
            ok = (res["bytes_equal"] and n_slabs == 4
                  and res["tier"] == ("resident" if resident == "1"
                                      else "streaming"))
            if name == "best":
                ok = ok and res["launches"]["min2"] == n_slabs * batches
            else:
                ok = ok and (res["launches"]["kstats"]
                             == 3 * n_slabs * batches)
            log("stream", part="a", run=name, **res)
            if not ok:
                raise AssertionError(f"stream (a) {name}, resident "
                                     f"{resident}: {res}")
    for path in (kmode["b"]["reads_file"], kmode["b"]["output_file"]):
        os.remove(path)
    log("stream", part="a", seconds=time.perf_counter() - t0)


def stream_db(rng, slab_plan, n: int = STREAM_ROWS, L: int = L_SMOKE,
              marks: tuple = (1 << 25,)) -> tuple[np.ndarray, list[int]]:
    """A full-size db: random_db's n windows of L bp (phase 8: 2^25 +
    2^20 at 60 bp), plus groups of 2, 5 and 40 across every slab boundary
    and across each index of ``marks``; returns (codes, the first row of
    each such group)."""
    codes = random_db(rng, n, L)
    slab_rows, n_slabs = slab_plan(n, L)
    starts = []
    for edge in [b * slab_rows for b in range(1, n_slabs)] + list(marks):
        for g, gap in ((2, 0), (5, 100), (40, 1000)):
            s0 = edge - g // 2 - gap
            codes[s0:s0 + g] = codes[s0]
            starts.append(s0)
    return codes, starts


def stream_reads(rng, codes: np.ndarray, starts: list[int], nq: int,
                 split: int = 1 << 25, max_subs: int = 6):
    """nq db windows with 0-max_subs substitutions, a third drawn from
    indices >= split, the first ones from the groups across slab edges."""
    n = codes.shape[0]
    src = np.concatenate([rng.integers(0, split, nq - nq // 3),
                          rng.integers(split, n, nq // 3)])
    src = rng.permutation(src)
    src[:len(starts)] = starts
    return mutate(rng, codes[src], max_subs)


def brute_force_stream(codes: np.ndarray, codes_t, q: np.ndarray,
                       qnums: list[int], k: int | None,
                       max_div: int | None) -> dict:
    """Reference lines of the sampled reads (qnum -> lines), from uint8
    code comparisons in plain torch on the card (``codes_t``, the db
    transposed, [L, W]): best-hit (lib.rs:306-313) when k is None, else
    K-mode (lib.rs:241-295) with no divergence limit."""
    L, n = codes_t.shape
    qt = torch.from_numpy(np.ascontiguousarray(q[qnums].T)).to(codes_t.device)
    dist = torch.empty((len(qnums), n), dtype=torch.uint8,
                       device=codes_t.device)
    step = 1 << 22
    for lo in range(0, n, step):
        d = torch.zeros((len(qnums), min(step, n - lo)), dtype=torch.uint8,
                        device=codes_t.device)
        for c in range(L):
            d += codes_t[c, lo:lo + step].unsqueeze(0) != qt[c].unsqueeze(1)
        dist[:, lo:lo + step] = d
    letters = np.frombuffer(b"ACGTN", np.uint8)
    out = {}
    for s, qnum in enumerate(qnums):
        row = dist[s]
        if k is None:
            eff = int(row.min())
            sel = (torch.nonzero(row == eff).flatten() if eff <= max_div
                   else None)
        else:
            cum = torch.cumsum(torch.bincount(row.to(torch.int64),
                                              minlength=L + 1), 0)
            eff = int(torch.nonzero(cum >= min(k, n))[0])
            sel = torch.nonzero(row <= eff).flatten()
        if sel is None:
            out[qnum] = []
            continue
        dv = row[sel].to(torch.int64)
        order = torch.sort(dv, stable=True).indices  # sel ascends
        idx, dv = sel[order].cpu().numpy(), dv[order].cpu().numpy()
        out[qnum] = [
            f"{qnum}\t{i}\t{d}\t{letters[codes[i]].tobytes().decode()}"
            for i, d in zip(idx.tolist(), dv.tolist())]
    return out


def sampled_lines(path: str, sample: set) -> dict:
    by_q: dict[int, list[str]] = {}
    with open(path) as f:
        for line in f:
            qnum = int(line[:line.index("\t")])
            if qnum in sample:
                by_q.setdefault(qnum, []).append(line.rstrip("\n"))
    return by_q


def stream_full(sizes, cli, query_mod, select_mod, slab_mod, mods, dev,
                tmp: str, rng, card: str) -> dict:
    """Phase 8 (b): the 34,603,008-window db through the CLI with no
    layout variable set: the stream layout chosen, its resident tier, then
    SMAFA_TPU_SLAB_RESIDENT=0 (the streaming tier), bytes equal; best-hit
    and K-mode, sampled reads against a brute force on the card. The db
    and the best-hit reads stay in ``tmp`` for phase 11 (b); returns
    their paths and the best-hit output's sha256."""
    from smafa_tpu_torch.core.windowset import WindowSet
    from smafa_tpu_torch.io import native_format

    t0 = time.perf_counter()
    codes, starts = stream_db(rng, slab_mod.slab_plan)
    n = codes.shape[0]
    db = os.path.join(tmp, "stream.native")
    native_format.save(WindowSet.from_matrix(codes, 2), db)
    log("stream", part="b", db_rows=n, build_db_s=time.perf_counter() - t0,
        straddling_groups=len(starts))
    codes_t = torch.from_numpy(codes).to(dev).T.contiguous()
    for name, nq, flags, k, max_div in (
            ("best", sizes.queries, ["--max-divergence", "5"], None, 5),
            ("kmode", sizes.stream_kmode_queries,
             ["--max-num-hits", str(sizes.kmode_k)], sizes.kmode_k, None)):
        q = stream_reads(rng, codes, starts, nq)
        q_fa = os.path.join(tmp, f"sq_{name}.fna")
        write_fasta(q_fa, q, "r")
        digests = []
        for env, tier in (({}, "resident"),
                          ({"SMAFA_TPU_SLAB_RESIDENT": "0"}, "streaming")):
            out = os.path.join(tmp, f"s_{tier}.tsv")
            res = stream_query(cli, query_mod, select_mod, mods,
                               ["query", "-d", db, "-q", q_fa, *flags, "-o",
                                out, "--quiet"], env, nq, n, card)
            res["sha256"], res["hit_lines"] = file_digest(out)
            digests.append(res["sha256"])
            want_log = [f"db layout: stream ({n} windows, length {L_SMOKE})"]
            n_slabs, batches = res["n_slabs"], -(-nq // 65536)
            key = "min2" if k is None else "kstats"
            per = n_slabs * batches * (1 if k is None else 3)
            ok = (res["tier"] == tier and res["log"][:1] == want_log
                  and f"{tier} tier" in res["log"][-1]
                  and res["launches"][key] == per
                  and res["launches"]["compact_mask"] >= 1)
            if tier == "resident":
                sample = sorted(rng.choice(nq, size=sizes.stream_sample,
                                           replace=False).tolist())
                got = sampled_lines(out, set(sample))
                want = brute_force_stream(codes, codes_t, q, sample, k,
                                          max_div)
                bad = [i for i in sample if got.get(i, []) != want[i]]
                res["sampled_exact"] = len(sample) - len(bad)
                ok = ok and not bad
            os.remove(out)
            log("stream", part="b", run=name, reads=nq, db_rows=n, **res)
            if not ok:
                raise AssertionError(f"stream (b) {name} {tier}: {res}")
        if name == "best":
            kept = {"db": db, "reads": q_fa, "flags": flags,
                    "sha256": digests[0], "reads_n": nq}
        else:
            os.remove(q_fa)
        if digests[0] != digests[1]:
            raise AssertionError(f"stream (b) {name}: the tiers' outputs "
                                 "differ")
    del codes_t
    torch.cuda.empty_cache()
    log("stream", part="b", seconds=time.perf_counter() - t0)
    return kept


# Phase 9: long windows past the global key budget, where smafa_tpu
# takes its top-M sort-merge and the port streams 2 slabs.
LONG_L = 150
LONG_ROWS = (1 << 22) + (1 << 20)
LONG_SLAB = (2_621_440, 2, 22)  # slab rows, slabs, slab-local shift


def events_ms(fn) -> tuple[float, object]:
    """(device ms of one fn() call by CUDA events, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def long_window_kernels(sizes, D, K, mods: dict, min2_mod, hitops, codes,
                        q_best, q_kmode, slab_rows: int, dev) -> dict:
    """Phase 9's kernels at its own shapes, each on its long route, held
    exactly to its plain version on the card and timed (CUDA events;
    plain once, the kernel over ``sizes.long_reps`` calls): min2 at the
    best-hit batch x one slab; kstats at the K-mode batch x one slab, at
    the first cutoff pass's probes; compact_mask at one K-mode dispatch
    (mask_row_cap(slab) reads) x one slab, at the reads' K = 99 cutoffs
    over the whole db (the cutoff search over the kstats kernel)."""
    L, ep = LONG_L, D.embed_width(LONG_L)
    n = codes.shape[0]
    shift = K.packing_shift(L, slab_rows)
    sms = min2_mod.sm_count(dev)
    slabs = []
    for off in range(0, n, slab_rows):
        part = torch.from_numpy(codes[off:off + slab_rows]).to(dev)
        slabs.append((*D.embed_db(part, L, slab_rows), part.shape[0]))
        del part
    emb, zc, n0 = slabs[0]
    out = {}

    def held(name, fn, ref, b, rows, bnd, **extra):
        plain_ms, want = events_ms(ref)
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} kernel differs from its plain "
                                 f"version at phase 9's shape B={b}")
        ms = time_ms(fn, sizes.long_reps)
        out[name] = log_time(name, L, b, rows, ms, plain_ms, bnd,
                             cell="long_windows", exact=True, **extra)

    m = mods["min2"]
    q_emb = D.expand_embed_query(torch.from_numpy(q_best).to(dev), L)
    b = q_emb.shape[0]
    held("min2", lambda: m.min2(q_emb, emb, zc, L, shift, True),
         lambda: D.min2_reference(q_emb, emb, zc, L, shift, True), b,
         n0, bound(b, n0, L, ep, out_bytes=3 * 4 * b),
         **dict(zip(("route", "splits"), min2_mod.kernel_plan(
             b, slab_rows, ep, sms))), shift=shift)
    del q_emb
    ks = mods["kstats"]
    q_emb = D.expand_embed_query(torch.from_numpy(q_kmode).to(dev), L)
    b = q_emb.shape[0]
    P = K.KSTATS_PROBES
    ts = torch.tensor([[L * i // P] for i in range(1, P)] + [[L]],
                      dtype=torch.int32, device=dev).expand(P, b).contiguous()
    held("kstats", lambda: ks.kstats(q_emb, emb, zc, ts, n0, L),
         lambda: D.stats_reference(q_emb, emb, zc, ts, n0, L), b, n0,
         bound(b, n0, L, ep, out_bytes=4 * (P + 1) * b,
               extra_in_bytes=4 * P * b),
         **live_plan(min2_mod, b, n0, ep, dev, "kstats"))

    def stats(t):
        cnt = mx = None
        for e, z, nv in slabs:
            c, x = ks.kstats(q_emb, e, z, t, nv, L)
            cnt, mx = (c, x) if cnt is None else (cnt + c,
                                                  torch.maximum(mx, x))
        return cnt, mx

    hm = mods["hist"]
    held("hist", lambda: (hm.hist(q_emb, emb, zc, n0, L),),
         lambda: (D.hist_reference(q_emb, emb, zc, n0, L),), b, n0,
         bound(b, n0, L, ep, out_bytes=4 * (L + 1) * b),
         **hist_plan(hm, b, n0, L, dev),
         **hist_vs_search(sizes, D, K, hm, ks, q_emb, emb, zc, n0, L,
                          sizes.long_reps))

    eff, _ = D.kmode_phase1(stats, sizes.kmode_k, L + 1, n, L, b, dev)
    cm = mods["compact_mask"]
    rows = min(hitops.mask_row_cap(slab_rows), b)
    qc, th = q_emb[:rows].contiguous(), eff[:rows].contiguous()
    held("compact_mask", lambda: (cm.compact_mask(qc, emb, zc, th, L),),
         lambda: (D.compact_mask_reference(qc, emb, zc, th, L),), rows, n0,
         bound(rows, n0, L, ep, out_bytes=rows * slab_rows // 8,
               extra_in_bytes=4 * rows),
         **dict(zip(("route", "splits"), cm.kernel_plan(
             rows, slab_rows, ep, sms))),
         k=sizes.kmode_k, thresh_median=float(th.float().median()))
    del slabs, emb, zc, q_emb, qc, ts
    torch.cuda.empty_cache()
    return out


# Phase 9's K-chunked lines: (kernel, L, reads) x LONG_ROUTE_ROWS db
# rows. min2, kstats and compact_mask past form (a)'s widths, 29,903 bp
# being phase 12 (b)'s width; min_count in form (a) at the cluster's
# batch x buffer.
LONG_ROUTE_SHAPES = (("min2", 300, 4096), ("kstats", 300, 1024),
                     ("min2", 29903, 4096), ("kstats", 29903, 1024),
                     ("compact_mask", 300, 4096),
                     ("compact_mask", 29903, 1024), ("min_count", 150, 32768),
                     ("hist", 300, 1024), ("hist", 1023, 1024))
LONG_ROUTE_ROWS = 32768


def long_route_kernels(sizes, D, K, mods: dict, min2_mod, dev,
                       seed: int) -> dict:
    """Each kernel on its K-chunked route at ``LONG_ROUTE_SHAPES``: B
    reads x 32,768 random db rows (a tenth copies of row 3; reads are db
    rows with ~5% substitutions, the first 4 copies of row 3; made on the
    card from ``seed``), each held exactly to its plain version and timed
    (CUDA events; plain once, the kernel over ``sizes.long_reps`` calls),
    with its route and db splits. kstats counts at the first cutoff
    pass's probes; compact_mask sets the reads' K = 99 cutoffs (the
    cutoff search over the kstats kernel), as K-mode compacts; min_count
    scans every row without the count, as the cluster calls it. The db
    is 3.9 GB at 29,903 bp, so its offsets pass 2^31 bytes."""
    sms = min2_mod.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows, P = LONG_ROUTE_ROWS, K.KSTATS_PROBES
    out = {}
    for name, L, b in LONG_ROUTE_SHAPES:
        ep = D.embed_width(L)
        codes = torch.randint(0, 4, (rows, L), generator=gen, device=dev,
                              dtype=torch.uint8)
        codes[torch.randint(0, rows, (rows // 10,), generator=gen,
                            device=dev)] = codes[3].clone()
        q = codes[torch.randint(0, rows, (b,), generator=gen,
                                device=dev)].clone()
        mut = torch.rand(q.shape, generator=gen, device=dev) < 0.05
        q[mut] = torch.randint(0, 4, (int(mut.sum()),), generator=gen,
                               device=dev, dtype=torch.uint8)
        q[:4] = codes[3]
        emb, zc = D.embed_db(codes, L, rows)
        q_emb = D.expand_embed_query(q, L)
        del codes, q
        plan = (dict(zip(("route", "splits"),
                         mods[name].kernel_plan(b, rows, ep, sms)))
                if name in ("min2", "compact_mask")
                else live_plan(min2_mod, b, rows, ep, dev, name)
                if name in ("kstats", "min_count") else {})
        extra = {}
        if name == "min2":
            shift = K.packing_shift(L, rows)
            args = (q_emb, emb, zc, L, shift, True)
            fn, ref = (lambda: mods["min2"].min2(*args),
                       lambda: D.min2_reference(*args))
            bnd = bound(b, rows, L, ep, out_bytes=3 * 4 * b)
        elif name == "kstats":
            ts = torch.tensor([[L * i // P] for i in range(1, P)] + [[L]],
                              dtype=torch.int32,
                              device=dev).expand(P, b).contiguous()
            args = (q_emb, emb, zc, ts, rows, L)
            fn, ref = (lambda: mods["kstats"].kstats(*args),
                       lambda: D.stats_reference(*args))
            bnd = bound(b, rows, L, ep, out_bytes=4 * (P + 1) * b,
                        extra_in_bytes=4 * P * b)
        elif name == "compact_mask":
            th, _ = D.kmode_phase1(
                lambda t: mods["kstats"].kstats(q_emb, emb, zc, t, rows, L),
                sizes.kmode_k, L + 1, rows, L, b, dev)
            args = (q_emb, emb, zc, th.contiguous(), L)
            fn, ref = (lambda: (mods["compact_mask"].compact_mask(*args),),
                       lambda: (D.compact_mask_reference(*args),))
            bnd = bound(b, rows, L, ep, out_bytes=b * rows // 8,
                        extra_in_bytes=4 * b)
            extra = {"k": sizes.kmode_k,
                     "thresh_median": float(th.float().median())}
        elif name == "hist":
            args = (q_emb, emb, zc, rows, L)
            fn, ref = (lambda: (mods["hist"].hist(*args),),
                       lambda: (D.hist_reference(*args),))
            bnd = bound(b, rows, L, ep, out_bytes=4 * (L + 1) * b)
            plan = hist_plan(mods["hist"], b, rows, L, dev)
            extra = hist_vs_search(sizes, D, K, mods["hist"], mods["kstats"],
                                   q_emb, emb, zc, rows, L, sizes.long_reps)
        else:
            shift = K.packing_shift(L, rows)
            args = (q_emb, emb, zc, rows, L, shift, False)
            fn, ref = (lambda: mods["min_count"].min_count(*args),
                       lambda: D.min_count_reference(*args))
            bnd = bound(b, rows, L, ep, out_bytes=4 * b)
        plain_ms, want = events_ms(ref)
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} kernel differs from its plain "
                                 f"version at L={L}, B={b}")
        ms = time_ms(fn, sizes.long_reps)
        out[f"{name}_{L}"] = log_time(name, L, b, rows, ms, plain_ms, bnd,
                                      cell="long_routes", exact=True, **plan,
                                      **extra)
        del emb, zc, q_emb, args, got, want
        torch.cuda.empty_cache()
    return out


def long_windows(sizes, cli, query_mod, select_mod, slab_mod, hitops, mods,
                 D, K, min2_mod, mc_mod, dev, tmp: str, rng,
                 card: str) -> dict:
    """Phase 9: 5,242,880 windows of 150 bp through the CLI with no layout
    variable set. Global keys (8 distance bits + 24 index bits) do not
    pack, nor does smafa_tpu's 2^24-row span, so smafa_tpu would take its
    top-M sort-merge; the port streams 2 slabs of 2,621,440 rows at shift
    22. Best-hit at --max-divergence 12 and K-mode at --max-num-hits 99,
    each in the resident tier and again with SMAFA_TPU_SLAB_RESIDENT=0:
    the tiers' bytes equal, min2 once and kstats kstats_steps(150) = 4
    times per slab per batch, compact_mask launched, 64 sampled reads a
    run against the brute force; then each long-route kernel at these
    shapes (``long_window_kernels``), and the kernels at
    ``LONG_ROUTE_SHAPES`` (``long_route_kernels``)."""
    from smafa_tpu_torch.core.windowset import WindowSet
    from smafa_tpu_torch.io import native_format

    t0 = time.perf_counter()
    L, n = LONG_L, LONG_ROWS
    codes, starts = stream_db(rng, slab_mod.slab_plan, n, L, ())
    slab_rows, n_slabs, shift = LONG_SLAB
    if (slab_mod.slab_plan(n, L) != (slab_rows, n_slabs)
            or K.packing_shift(L, 2 * n) is not None):
        raise AssertionError(f"long windows: plan {slab_mod.slab_plan(n, L)}")
    db = os.path.join(tmp, "long.native")
    native_format.save(WindowSet.from_matrix(codes, 2), db)
    log("long_windows", db_rows=n, L=L, build_db_s=time.perf_counter() - t0,
        straddling_groups=len(starts))
    codes_t = torch.from_numpy(codes).to(dev).T.contiguous()
    steps = K.kstats_steps(L)
    want_log = [f"db layout: stream ({n} windows, length {L})",
                f"stream layout: {n_slabs} slabs of {slab_rows} rows "
                f"(slab-local shift {shift}), resident tier"]
    reads = {}
    for name, nq, flags, k, max_div in (
            ("best", sizes.long_queries, ["--max-divergence", "12"], None,
             12),
            ("kmode", sizes.long_kmode_queries,
             ["--max-num-hits", str(sizes.kmode_k)], sizes.kmode_k, None)):
        q = stream_reads(rng, codes, starts, nq, split=slab_rows, max_subs=15)
        reads[name] = q
        q_fa = os.path.join(tmp, "lq.fna")
        write_fasta(q_fa, q, "r")
        digests = []
        for env, tier in (({}, "resident"),
                          ({"SMAFA_TPU_SLAB_RESIDENT": "0"}, "streaming")):
            out = os.path.join(tmp, f"l_{tier}.tsv")
            res = stream_query(cli, query_mod, select_mod, mods,
                               ["query", "-d", db, "-q", q_fa, *flags, "-o",
                                out, "--quiet"], env, nq, n, card)
            res["sha256"], res["hit_lines"] = file_digest(out)
            digests.append(res["sha256"])
            batches = -(-nq // 65536)
            key = "min2" if k is None else "kstats"
            per = n_slabs * batches * (1 if k is None else steps)
            ok = (res["tier"] == tier and res["n_slabs"] == n_slabs
                  and res["slab_rows"] == slab_rows
                  and res["log"][:1] == want_log[:1]
                  and res["log"][-1] == want_log[1].replace("resident", tier)
                  and res["launches"][key] == per
                  and res["launches"]["compact_mask"] >= 1)
            if tier == "resident":
                sample = sorted(rng.choice(nq, size=sizes.stream_sample,
                                           replace=False).tolist())
                got = sampled_lines(out, set(sample))
                want = brute_force_stream(codes, codes_t, q, sample, k,
                                          max_div)
                bad = [i for i in sample if got.get(i, []) != want[i]]
                res["sampled_exact"] = len(sample) - len(bad)
                ok = ok and not bad
            os.remove(out)
            log("long_windows", run=name, reads=nq, db_rows=n, L=L, **res)
            if not ok:
                raise AssertionError(f"long windows {name} {tier}: {res}")
        if k is not None:  # the K-mode run again with the histogram
            out = os.path.join(tmp, "l_hist.tsv")
            res = stream_query(cli, query_mod, select_mod, mods,
                               ["query", "-d", db, "-q", q_fa, *flags, "-o",
                                out, "--quiet"], {KMODE_HIST: "1"}, nq, n,
                               card)
            res["sha256"], res["hit_lines"] = file_digest(out)
            os.remove(out)
            per = n_slabs * -(-nq // 65536)
            log("long_windows", run="kmode_hist", reads=nq, db_rows=n, L=L,
                **res)
            if (res["sha256"] != digests[0] or res["tier"] != "resident"
                    or res["launches"]["hist"] != per
                    or res["launches"]["kstats"] != 0):
                raise AssertionError(f"long windows kmode with "
                                     f"{KMODE_HIST}=1: {res}")
        os.remove(q_fa)
        if digests[0] != digests[1]:
            raise AssertionError(f"long windows {name}: the tiers' outputs "
                                 "differ")
    del codes_t
    os.remove(db)
    torch.cuda.empty_cache()
    timing = long_window_kernels(sizes, D, K, mods, min2_mod, hitops, codes,
                                 reads["best"], reads["kmode"], slab_rows,
                                 dev)
    del codes, reads
    timing.update(long_route_kernels(sizes, D, K,
                                     {**mods, "min_count": mc_mod}, min2_mod,
                                     dev, int(rng.integers(1 << 31))))
    log("long_windows", seconds=time.perf_counter() - t0, card=card)
    return timing


# Phase 10: the cluster's centroid scan in spans past the key budget.
SPAN_CUT_BITS = 12             # (a): cluster 1M's 32,768-row buffer in 4,096-row spans
SPAN_L = 300
SPAN_ROWS = (1 << 22) + (1 << 20)  # (b): cap 2^23 does not pack at 300 bp


def cut_index_bits(real, bits: int):
    """``keys.packing_shift`` that packs no span wider than 2^bits rows
    (patched in-process over the keys module, which the cluster engine
    reaches as ``cluster.K``; the package has no knob for this)."""
    def packing_shift(seq_len, wp):
        shift = real(seq_len, wp)
        return shift if shift is not None and shift <= bits else None
    return packing_shift


def cluster_spans(sizes, cli, cluster_mod, mc_mod, D, K, min2_mod, clu: dict,
                  cluster_inp: str, dev, tmp: str, rng, card: str) -> dict:
    """Phase 10. (a) Cluster 1M through the CLI with the key budget cut so
    that its 32,768-row buffer scans in spans of 4,096 rows: phase 5's
    centroid count and sha256, one min_count launch per span holding
    centroids per batch. (b) A store of 5,242,880 random 300 bp
    centroids (cap 2^23, which does not pack at 9 distance bits: 2 spans
    of 2^22 rows) built with ``_CentroidStore.from_codes``; one batch of
    reads through ``scan_async`` / ``scan_fetch``, timed, 256 sampled
    rows against a brute force over the codes on the card; min_count at
    its first span held to its plain version and timed."""
    t0 = time.perf_counter()
    span = 1 << SPAN_CUT_BITS
    out = os.path.join(tmp, "c_spans.tsv")
    mc_mod.launches = 0
    with mock.patch.object(cluster_mod.K, "packing_shift", cut_index_bits(
            cluster_mod.K.packing_shift, SPAN_CUT_BITS)):
        rc, wall, timers, shapes = cluster_cli(cli, cluster_mod, [
            "cluster", "-i", cluster_inp, "-d", str(sizes.cluster_div), "-o",
            out, "--quiet"])
    launches = mc_mod.launches
    with open(out, "rb") as f:
        sha, _, _, n_cent = cluster_lines(f.read(), L_SMOKE)
    os.remove(out)
    want_launches = sum(-(-nv // span) for _, nv, _ in clu["min_count_shapes"])
    res_a = {"part": "a", "span_rows": span, "rc": rc, "wall_s": wall,
             "stage_s": timers and timers.seconds, "sha256": sha,
             "centroids": n_cent, "sha256_equals_smafa_tpu":
             sha == CLUSTER_SHA256, "launches": {"min_count": launches},
             "want_launches": want_launches,
             "buffer_rows": sorted({w for *_, w in shapes}), "card": card}
    log("cluster_spans", **res_a)
    if (rc != 0 or sha != CLUSTER_SHA256 or n_cent != CLUSTER_CENTROIDS
            or launches != want_launches or len(shapes) != launches
            or {w for *_, w in shapes} != {span}):
        raise AssertionError(f"cluster spans (a): {res_a}")

    t1 = time.perf_counter()
    L, n, b = SPAN_L, SPAN_ROWS, sizes.span_queries
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    half = K.packing_span(L)  # 2^22 rows at 9 distance bits
    # copies of span-0 rows in span 1: exact reads tie across the spans
    dup_src = rng.integers(0, half, 64)
    codes[half + rng.permutation(n - half)[:64]] = codes[dup_src]
    store = cluster_mod._CentroidStore.from_codes(codes, dev)
    build_s = time.perf_counter() - t1
    if store.span != half or store.cap <= half:
        raise AssertionError(f"cluster spans (b): cap {store.cap}, span "
                             f"{store.span}")
    src = np.concatenate([rng.integers(0, half, b - b // 3),
                          rng.integers(half, n, b // 3)])
    q = mutate(rng, codes[rng.permutation(src)], 20)
    q[:64] = codes[dup_src]
    mc_mod.launches = 0
    scan_ms, (dist, idx) = events_ms(
        lambda: store.scan_fetch(store.scan_async(q)))
    launches = mc_mod.launches
    codes_t = torch.from_numpy(codes).to(dev).T.contiguous()
    sample = np.concatenate([np.arange(64), np.sort(rng.choice(
        np.arange(64, b), size=sizes.span_sample - 64, replace=False))])
    qt = torch.from_numpy(np.ascontiguousarray(q[sample].T)).to(dev)
    d = torch.zeros((sample.size, n), dtype=torch.int16, device=dev)
    for c in range(L):
        d += codes_t[c].unsqueeze(0) != qt[c].unsqueeze(1)
    want_d, want_i = d.min(dim=1)  # min(dim) takes the first index
    bad = np.nonzero((want_d.cpu().numpy() != dist[sample])
                     | (want_i.cpu().numpy() != idx[sample]))[0]
    del codes_t, qt, d
    # min_count on its first span, as the scan launched it
    ep = D.embed_width(L)
    q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L)
    emb, zc = store.db_emb[:half], store.zc[:half]
    plain_ms, want = events_ms(lambda: D.min_count_reference(
        q_emb, emb, zc, half, L, store.shift, False))
    got = mc_mod.min_count(q_emb, emb, zc, half, L, store.shift, False)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError("min_count kernel differs from its plain "
                             "version at phase 10's span")
    ms = time_ms(lambda: mc_mod.min_count(q_emb, emb, zc, half, L,
                                          store.shift, False),
                 sizes.long_reps)
    timing = log_time("min_count", L, b, half, ms, plain_ms,
                      bound(b, half, L, ep, out_bytes=4 * b),
                      cell="cluster_spans", exact=True,
                      **live_plan(min2_mod, b, half, ep, dev, "min_count"))
    res_b = {"part": "b", "centroids": n, "L": L, "cap": store.cap,
             "span": store.span, "shift": store.shift, "reads": b,
             "build_s": build_s, "scan_ms": scan_ms,
             "comparisons_per_s": b * n / (scan_ms / 1e3),
             "launches": {"min_count": launches},
             "sampled": int(sample.size), "sampled_exact":
             int(sample.size - bad.size), "mismatches": bad[:5].tolist(),
             "tied_reads_lowest_index": bool(
                 (idx[:64] == dup_src).all()), "card": card}
    log("cluster_spans", **res_b)
    del store, q_emb, emb, zc, got, want
    torch.cuda.empty_cache()
    if (bad.size or launches != -(-n // half)
            or not res_b["tied_reads_lowest_index"]):
        raise AssertionError(f"cluster spans (b): {res_b}")
    log("cluster_spans", seconds=time.perf_counter() - t0)
    return timing


# Phase 11: the multi-process path, ranks as subprocesses of the CLI on
# the one card (gloo: NCCL refuses two ranks on one card).
MP_ROWS = 10_000_000  # (a): BASELINE config 5 cut to one card
MP_RANKS = 2
MP_TIMEOUT = 300      # seconds a rank may take before every rank is killed


def rank_worker(out_json: str, argv: list[str]) -> int:
    """``chip_smoke.py --rank OUT ARGV...``: one rank of phases 11-12 (or
    phase 12 (c)'s process without a coordinator). Runs the CLI on ARGV
    with the kernels' counts set to 0 just before and read just after,
    and writes to OUT its exit code, wall, stages, launches, the seconds
    its merges' collectives took, its layout, the ring's rotations and
    the col layout's columns."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from smafa_tpu_torch import cli
    from smafa_tpu_torch.engine import cluster as cluster_mod, query as query_mod
    from smafa_tpu_torch.ops import compact, hist, kstats, min2, min_count
    from smafa_tpu_torch.parallel import select as select_mod

    mods = {"min2": min2, "compact_mask": compact, "kstats": kstats,
            "min_count": min_count, "hist": hist}
    runners, stores, timers = [], [], []
    make, store_cls = select_mod.make_runner, cluster_mod._CentroidStore

    def make_spy(*a, **kw):
        runners.append(make(*a, **kw))
        return runners[-1]

    class Store(store_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stores.append(self)

    def engine_spy(fn):
        def run(*a, **kw):
            timers.append(fn(*a, **kw))
            return timers[-1]
        return run

    select_mod.make_runner = make_spy
    cluster_mod._CentroidStore = Store
    query_mod.query = engine_spy(query_mod.query)
    cluster_mod.cluster = engine_spy(cluster_mod.cluster)
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    res = {"rc": rc, "wall_s": wall,
           "launches": {name: mod.launches for name, mod in mods.items()},
           "stage_s": timers[0].seconds if timers else None}
    if runners:
        r = runners[0]
        res.update(layout=type(r).__name__, merge_s=getattr(r, "merge_s", None),
                   local=type(getattr(r, "local", None)).__name__,
                   rows=[getattr(r, "off", 0),
                         getattr(r, "n_local", r.n_windows)],
                   # the ring's rotations; the col layout's column slice
                   rotations=getattr(r, "rotations", None),
                   rotate_bytes=getattr(r, "rotate_bytes", None),
                   rotate_s=getattr(r, "rotate_s", None),
                   columns=[getattr(r, "c0", None), getattr(r, "c1", None)])
    if stores:
        res.update(merge_s=stores[0].merge_s, shard_rows=stores[0].shard_rows,
                   sharded=stores[0].comm is not None)
    with open(out_json, "w") as f:
        json.dump(res, f)
    return 0


def run_ranks(argv: list[str], tmp: str, n: int = MP_RANKS,
              env: dict | None = None) -> list[dict]:
    """The CLI on ``argv`` as n ranks (``rank_worker`` subprocesses, with
    ``env`` added to their environment) with a coordinator on a free
    local port: each rank's record and its log's lines about the process
    group and the layout. Kills every rank when one fails or times out."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, outs = [], []
    try:
        for r in range(n):
            out = os.path.join(tmp, f"rank{r}.json")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", out,
                 *argv, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(n), "--process-id", str(r)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                env={**os.environ, **(env or {})}))
        errs = [p.communicate(timeout=MP_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    runs = []
    for p, out, err in zip(procs, outs, errs):
        if p.returncode != 0 or not os.path.exists(out):
            raise AssertionError(f"rank failed: rc={p.returncode}, "
                                 f"stderr {err[-3000:]}")
        with open(out) as f:
            rec = json.load(f)
        os.remove(out)
        rec["log"] = [line.split("] ", 1)[-1] for line in err.splitlines()
                      if "distributed:" in line or "layout" in line
                      or "split" in line]
        if rec["rc"] != 0:
            raise AssertionError(f"rank CLI failed: {rec}, {err[-3000:]}")
        runs.append(rec)
    return runs


def multiprocess(sizes, cli, query_mod, cluster_mod, mods: dict, dev,
                 tmp: str, rng, card: str, stream_kept: dict,
                 cluster_inp: str) -> dict:
    """Phase 11: ``query`` and ``cluster`` through the CLI as 2 ranks on
    the card (gloo), each rank holding one row shard. (a) BASELINE config
    5 cut to one card: 10,000,000 windows of 60 bp in the native format
    (5,000,000 a rank), best-hit on 65,536 reads at --max-divergence 5
    and K = 99 on 16,384 reads, both with the query split; each sha256
    equal to the port's single-process run on the same files, 64 sampled
    reads a run equal to a brute force. (b) Phase 8's 34,603,008-window
    db in 2 ranks (global keys overflow, each shard packs alone): the
    best-hit sha256 equal to phase 8's. (c) cluster 1M in 2 ranks:
    phase 5's sha256 and centroid count. (d) one rank with a coordinator,
    which takes NCCL on the card, on (a)'s best-hit run. (a)'s db, codes,
    reads and single-process sha256s stay for phase 12: returns them."""
    from smafa_tpu_torch.core.windowset import WindowSet
    from smafa_tpu_torch.io import native_format

    t0 = time.perf_counter()
    codes = random_db(rng, MP_ROWS, L_SMOKE)
    db = os.path.join(tmp, "mp.native")
    native_format.save(WindowSet.from_matrix(codes, 2), db)
    log("multiprocess", part="a", db_rows=MP_ROWS,
        build_db_s=time.perf_counter() - t0, card=card)
    codes_t = torch.from_numpy(codes).to(dev).T.contiguous()
    kept = {"db": db, "codes": codes, "runs": []}
    for name, nq, flags, k, max_div in (
            ("best", sizes.queries, ["--max-divergence", "5"], None, 5),
            ("kmode", sizes.stream_kmode_queries,
             ["--max-num-hits", str(sizes.kmode_k)], sizes.kmode_k, None)):
        src = rng.integers(0, MP_ROWS, nq)
        q = mutate(rng, codes[src], 6)
        q_fa = os.path.join(tmp, f"mp_{name}.fna")
        write_fasta(q_fa, q, "r")
        single = os.path.join(tmp, "mp_single.tsv")
        for mod in mods.values():
            mod.launches = 0
        rc, wall1, timers = cli_query(cli, query_mod, [
            "query", "-d", db, "-q", q_fa, *flags, "-o", single, "--quiet"])
        launches1 = {k_: mod.launches for k_, mod in mods.items()}
        want_sha, lines = file_digest(single)
        out = os.path.join(tmp, "mp_ranks.tsv")
        runs = run_ranks(["query", "-d", db, "-q", q_fa, *flags, "-o", out,
                          "-v"], tmp)
        sha, _ = file_digest(out)
        sample = sorted(rng.choice(nq, size=sizes.stream_sample,
                                   replace=False).tolist())
        got = sampled_lines(out, set(sample))
        want = brute_force_stream(codes, codes_t, q, sample, k, max_div)
        bad = [i for i in sample if got.get(i, []) != want[i]]
        key = "min2" if k is None else "kstats"
        res = {"part": "a", "run": name, "reads": nq, "db_rows": MP_ROWS,
               "ranks": MP_RANKS, "rc": rc, "hit_lines": lines,
               "sha256": sha, "sha256_single": want_sha,
               "sha256_equal": sha == want_sha,
               "sampled_exact": len(sample) - len(bad),
               "single_wall_s": wall1, "single_stage_s": timers.seconds,
               "single_reads_per_s": nq / wall1,
               "single_launches": launches1,
               "wall_s": [r["wall_s"] for r in runs],
               "reads_per_s": nq / max(r["wall_s"] for r in runs),
               "stage_s": [r["stage_s"] for r in runs],
               "merge_s": [r["merge_s"] for r in runs],
               "launches": [r["launches"] for r in runs],
               "rows": [r["rows"] for r in runs],
               "log": runs[0]["log"] + runs[1]["log"], "card": card}
        log("multiprocess", **res)
        split = any("split across 2 processes" in x for x in runs[0]["log"])
        if (rc != 0 or sha != want_sha or bad or not split
                or any(r["launches"][key] <= 0 for r in runs)
                or [r["rows"] for r in runs] != [[0, MP_ROWS // 2],
                                                [MP_ROWS // 2, MP_ROWS // 2]]):
            raise AssertionError(f"multiprocess (a) {name}: {res}")
        os.remove(out)
        os.remove(single)
        if k is not None:  # the K-mode run again with the histogram
            runs = run_ranks(["query", "-d", db, "-q", q_fa, *flags, "-o",
                              out, "-v"], tmp, env={KMODE_HIST: "1"})
            sha, _ = file_digest(out)
            os.remove(out)
            res = {"part": "a", "run": "kmode_hist", "reads": nq,
                   "ranks": MP_RANKS, "sha256": sha,
                   "sha256_equal": sha == want_sha,
                   "wall_s": [r["wall_s"] for r in runs],
                   "reads_per_s": nq / max(r["wall_s"] for r in runs),
                   "stage_s": [r["stage_s"] for r in runs],
                   "merge_s": [r["merge_s"] for r in runs],
                   "launches": [r["launches"] for r in runs], "card": card}
            log("multiprocess", **res)
            if sha != want_sha or any(
                    r["launches"]["hist"] <= 0 or r["launches"]["kstats"]
                    for r in runs):
                raise AssertionError(f"multiprocess (a) kmode with "
                                     f"{KMODE_HIST}=1: {res}")
        kept["runs"].append({"name": name, "q": q, "reads": q_fa,
                             "flags": flags, "k": k, "max_div": max_div,
                             "sha256": want_sha})
    del codes_t
    torch.cuda.empty_cache()

    # (b): past the global key budget, each rank's shard alone packs
    out = os.path.join(tmp, "mp_b.tsv")
    runs = run_ranks(["query", "-d", stream_kept["db"], "-q",
                      stream_kept["reads"], *stream_kept["flags"], "-o", out,
                      "-v"], tmp)
    sha, lines = file_digest(out)
    os.remove(out)
    nq = stream_kept["reads_n"]
    res = {"part": "b", "db_rows": STREAM_ROWS, "reads": nq,
           "hit_lines": lines, "sha256": sha,
           "sha256_phase8": stream_kept["sha256"],
           "sha256_equal": sha == stream_kept["sha256"],
           "wall_s": [r["wall_s"] for r in runs],
           "reads_per_s": nq / max(r["wall_s"] for r in runs),
           "stage_s": [r["stage_s"] for r in runs],
           "merge_s": [r["merge_s"] for r in runs],
           "launches": [r["launches"] for r in runs],
           "local": [r["local"] for r in runs],
           "rows": [r["rows"] for r in runs],
           "log": runs[0]["log"] + runs[1]["log"], "card": card}
    log("multiprocess", **res)
    if sha != stream_kept["sha256"] or any(r["launches"]["min2"] <= 0
                                           for r in runs):
        raise AssertionError(f"multiprocess (b): {res}")
    os.remove(stream_kept["db"])
    os.remove(stream_kept["reads"])

    # (c): cluster 1M, the centroid buffer sharded over the ranks
    out = os.path.join(tmp, "mp_c.tsv")
    runs = run_ranks(["cluster", "-i", cluster_inp, "-d",
                      str(sizes.cluster_div), "-o", out, "-v"], tmp)
    with open(out, "rb") as f:
        sha, _, _, n_cent = cluster_lines(f.read(), L_SMOKE)
    os.remove(out)
    res = {"part": "c", "records": sizes.cluster_records, "sha256": sha,
           "sha256_equals_smafa_tpu": sha == CLUSTER_SHA256,
           "centroids": n_cent, "wall_s": [r["wall_s"] for r in runs],
           "records_per_s": sizes.cluster_records / max(
               r["wall_s"] for r in runs),
           "stage_s": [r["stage_s"] for r in runs],
           "merge_s": [r["merge_s"] for r in runs],
           "launches": [r["launches"] for r in runs],
           "sharded": [r["sharded"] for r in runs],
           "shard_rows": [r["shard_rows"] for r in runs],
           "log": runs[0]["log"] + runs[1]["log"], "card": card}
    log("multiprocess", **res)
    if (sha != CLUSTER_SHA256 or n_cent != CLUSTER_CENTROIDS
            or not all(res["sharded"])
            or any(r["launches"]["min_count"] <= 0 for r in runs)):
        raise AssertionError(f"multiprocess (c): {res}")

    # (d): one rank with a coordinator: NCCL for the device collectives
    best = kept["runs"][0]
    q_fa, flags, want_sha = best["reads"], best["flags"], best["sha256"]
    out = os.path.join(tmp, "mp_d.tsv")
    runs = run_ranks(["query", "-d", db, "-q", q_fa, *flags, "-o", out,
                      "-v"], tmp, n=1)
    sha, _ = file_digest(out)
    os.remove(out)
    res = {"part": "d", "ranks": 1, "sha256": sha,
           "sha256_equal": sha == want_sha, "wall_s": runs[0]["wall_s"],
           "stage_s": runs[0]["stage_s"], "merge_s": runs[0]["merge_s"],
           "launches": runs[0]["launches"], "log": runs[0]["log"],
           "card": card}
    log("multiprocess", **res)
    nccl = any("device collectives nccl" in x for x in runs[0]["log"])
    if sha != want_sha or not nccl or runs[0]["launches"]["min2"] <= 0:
        raise AssertionError(f"multiprocess (d): {res}")
    log("multiprocess", seconds=time.perf_counter() - t0, card=card)
    return kept


# Phase 12: the ring and column-sharded layouts through the CLI, and the
# profiler hook.
COL_ROWS = 32768
COL_L = 29903   # SARS-CoV-2 genome width (Wuhan-Hu-1, MN908947.3)
COL_SUBS = 300  # substitutions a read at most


def rank_fields(runs: list[dict], nq: int) -> dict:
    """The ranks' records side by side: walls, reads/s of the slowest,
    stages, merges, launches, the ring's rotations and the col layout's
    column slices."""
    return {"wall_s": [r["wall_s"] for r in runs],
            "reads_per_s": nq / max(r["wall_s"] for r in runs),
            "stage_s": [r["stage_s"] for r in runs],
            "merge_s": [r["merge_s"] for r in runs],
            "launches": [r["launches"] for r in runs],
            "runner": [r["layout"] for r in runs],
            "rows": [r["rows"] for r in runs],
            "rotations": [r["rotations"] for r in runs],
            "rotate_bytes": [r["rotate_bytes"] for r in runs],
            "rotate_s": [r["rotate_s"] for r in runs],
            "columns": [r["columns"] for r in runs],
            "log": [line for r in runs for line in r["log"]]}


def layouts(sizes, cli, query_mod, mods: dict, dev, tmp: str, rng,
            card: str, mp_kept: dict, e2e: dict, smoke_db: str) -> None:
    """Phase 12: ``query`` through the CLI under SMAFA_TPU_LAYOUT=ring and
    col, as 2 ranks sharing the card over gloo (``run_ranks``) and as 1
    rank on NCCL. (a) ring on phase 11 (a)'s 10,000,000 x 60 bp db and
    reads: each sha256 equal to phase 11's single-process run, 64 sampled
    reads a run equal to the brute force, every rank launching min2
    (best-hit), kstats and compact_mask (K-mode) and rotating; then 1
    rank on NCCL, best-hit. (b) col on 32,768 random windows of 29,903 bp
    (reads 0-300 substitutions off db rows): best-hit on 4,096 reads at
    --max-divergence 300 and K = 99 on 1,024 reads (the latter under the
    auto rule, which takes col over 2 processes at this width), each
    sha256 equal to the single process's (sharded, on the long-route
    kernels); the best-hit run also in 2 ranks under sharded, timed
    beside col; then 1 rank on NCCL, best-hit. (c) the query smoke's
    best-hit run through the CLI in a process of its own, untraced and
    with SMAFA_TPU_TRACE_DIR set: one trace file, naming the min2
    kernel, and the smoke's bytes both times."""
    from smafa_tpu_torch.core.windowset import WindowSet
    from smafa_tpu_torch.io import native_format

    t0 = time.perf_counter()
    ring = {"SMAFA_TPU_LAYOUT": "ring"}
    codes = mp_kept["codes"]
    codes_t = torch.from_numpy(codes).to(dev).T.contiguous()
    for run in mp_kept["runs"]:
        out = os.path.join(tmp, "ring.tsv")
        runs = run_ranks(["query", "-d", mp_kept["db"], "-q", run["reads"],
                          *run["flags"], "-o", out, "-v"], tmp, env=ring)
        sha, lines = file_digest(out)
        nq = run["q"].shape[0]
        sample = sorted(rng.choice(nq, size=sizes.stream_sample,
                                   replace=False).tolist())
        got = sampled_lines(out, set(sample))
        want = brute_force_stream(codes, codes_t, run["q"], sample, run["k"],
                                  run["max_div"])
        bad = [i for i in sample if got.get(i, []) != want[i]]
        os.remove(out)
        res = {"part": "a", "layout": "ring", "run": run["name"],
               "reads": nq, "db_rows": MP_ROWS, "ranks": MP_RANKS,
               "hit_lines": lines, "sha256": sha,
               "sha256_single": run["sha256"],
               "sha256_equal": sha == run["sha256"],
               "sampled_exact": len(sample) - len(bad),
               **rank_fields(runs, nq), "card": card}
        log("layouts", **res)
        need = ["min2"] if run["k"] is None else ["kstats", "compact_mask"]
        if (sha != run["sha256"] or bad
                or res["runner"] != ["RingRunner"] * MP_RANKS
                or any(r["launches"][k] <= 0 for r in runs for k in need)
                or any(r["rotations"] <= 0 for r in runs)):
            raise AssertionError(f"layouts (a) {run['name']}: {res}")
    del codes_t
    torch.cuda.empty_cache()
    best = mp_kept["runs"][0]
    out = os.path.join(tmp, "ring1.tsv")
    runs = run_ranks(["query", "-d", mp_kept["db"], "-q", best["reads"],
                      *best["flags"], "-o", out, "-v"], tmp, n=1, env=ring)
    sha, _ = file_digest(out)
    os.remove(out)
    res = {"part": "a", "layout": "ring", "run": "best", "ranks": 1,
           "sha256": sha, "sha256_equal": sha == best["sha256"],
           **rank_fields(runs, best["q"].shape[0]), "card": card}
    log("layouts", **res)
    nccl = any("device collectives nccl" in x for x in res["log"])
    if (sha != best["sha256"] or not nccl or res["rotations"] != [0]
            or runs[0]["launches"]["min2"] <= 0):
        raise AssertionError(f"layouts (a) 1 rank: {res}")
    for run in mp_kept["runs"]:
        os.remove(run["reads"])
    os.remove(mp_kept["db"])
    mp_kept.clear()

    # (b): long windows, the column-sharded layout against the row shards
    t1 = time.perf_counter()
    codes = random_db(rng, COL_ROWS, COL_L)
    db = os.path.join(tmp, "col.native")
    native_format.save(WindowSet.from_matrix(codes, 2), db)
    reads = []
    for name, nq, flags in (
            ("best", 4096, ["--max-divergence", str(COL_SUBS)]),
            ("kmode", 1024, ["--max-num-hits", str(sizes.kmode_k)])):
        q_fa = os.path.join(tmp, f"col_{name}.fna")
        write_fasta(q_fa, mutate(rng, codes[rng.integers(0, COL_ROWS, nq)],
                                 COL_SUBS), "r")
        reads.append((name, nq, q_fa, flags))
    del codes
    log("layouts", part="b", db_rows=COL_ROWS, L=COL_L,
        build_db_s=time.perf_counter() - t1, card=card)
    for name, nq, q_fa, flags in reads:
        argv = ["query", "-d", db, "-q", q_fa, *flags]
        single = os.path.join(tmp, "col_single.tsv")
        for mod in mods.values():
            mod.launches = 0
        rc, wall1, timers = cli_query(cli, query_mod,
                                      [*argv, "-o", single, "--quiet"])
        launches1 = {k: mod.launches for k, mod in mods.items()}
        want_sha, lines = file_digest(single)
        os.remove(single)
        if name == "kmode":  # L >= HIST_MAX: the switch keeps kstats
            for mod in mods.values():
                mod.launches = 0
            os.environ[KMODE_HIST] = "1"
            try:
                rc_h, wall_h, _ = cli_query(cli, query_mod,
                                            [*argv, "-o", single, "--quiet"])
            finally:
                del os.environ[KMODE_HIST]
            launches_h = {k: mod.launches for k, mod in mods.items()}
            sha_h, _ = file_digest(single)
            os.remove(single)
            log("layouts", part="b", run="kmode_hist", reads=nq, L=COL_L,
                rc=rc_h, wall_s=wall_h, launches=launches_h, sha256=sha_h,
                sha256_equal=sha_h == want_sha, card=card)
            if (rc_h != 0 or sha_h != want_sha or launches_h["hist"] != 0
                    or launches_h["kstats"] <= 0):
                raise AssertionError(f"layouts (b) kmode with "
                                     f"{KMODE_HIST}=1: {launches_h}")
        res = {"part": "b", "run": name, "reads": nq, "db_rows": COL_ROWS,
               "L": COL_L, "ranks": MP_RANKS, "rc": rc, "hit_lines": lines,
               "sha256_single": want_sha, "single_wall_s": wall1,
               "single_stage_s": timers.seconds,
               "single_reads_per_s": nq / wall1,
               "single_launches": launches1, "card": card}
        # K-mode under the auto rule, which takes col here
        for layout in ("col", "sharded") if name == "best" else ("auto",):
            out = os.path.join(tmp, f"col_{layout}.tsv")
            runs = run_ranks([*argv, "-o", out, "-v"], tmp,
                             env={"SMAFA_TPU_LAYOUT": layout})
            sha, _ = file_digest(out)
            os.remove(out)
            res[layout] = {"sha256": sha, "sha256_equal": sha == want_sha,
                           **rank_fields(runs, nq)}
        if name == "best":
            res["col_over_sharded_wall"] = (max(res["col"]["wall_s"])
                                            / max(res["sharded"]["wall_s"]))
        log("layouts", **res)
        runner = {"col": "ColumnShardedRunner", "auto": "ColumnShardedRunner",
                  "sharded": "ShardedRunner"}
        if rc != 0 or any(not res[x]["sha256_equal"]
                          or res[x]["runner"] != [runner[x]] * MP_RANKS
                          for x in runner if x in res):
            raise AssertionError(f"layouts (b) {name}: {res}")
        if name == "best":
            best = (argv, want_sha, nq)
    argv, want_sha, nq = best
    out = os.path.join(tmp, "col1.tsv")
    runs = run_ranks([*argv, "-o", out, "-v"], tmp, n=1,
                     env={"SMAFA_TPU_LAYOUT": "col"})
    sha, _ = file_digest(out)
    os.remove(out)
    res = {"part": "b", "layout": "col", "run": "best", "ranks": 1,
           "sha256": sha, "sha256_equal": sha == want_sha,
           **rank_fields(runs, nq), "card": card}
    log("layouts", **res)
    nccl = any("device collectives nccl" in x for x in res["log"])
    if sha != want_sha or not nccl:
        raise AssertionError(f"layouts (b) 1 rank: {res}")
    for _name, _nq, q_fa, _flags in reads:
        os.remove(q_fa)
    os.remove(db)

    # (c): the query smoke traced by torch.profiler, in a process of its
    # own as a user runs it (in this process, after the profiler sessions
    # of the earlier phases, one trace held 30 of the run's 62 kernel
    # events and no min2), beside the same run untraced
    trace_dir = os.path.join(tmp, "trace")
    out = os.path.join(tmp, "traced.tsv")
    want_sha, _ = file_digest(e2e["output"])
    recs = {}
    for name, env in (("untraced", {}),
                      ("traced", {"SMAFA_TPU_TRACE_DIR": trace_dir})):
        rec = os.path.join(tmp, "traced.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--rank", rec,
             "query", "-d", smoke_db, "-q", e2e["reads"], "--max-divergence",
             "5", "-o", out, "--quiet"], capture_output=True, text=True,
            timeout=MP_TIMEOUT, env={**os.environ, **env})
        if proc.returncode != 0 or not os.path.exists(rec):
            raise AssertionError(f"layouts (c) {name}: {proc.stderr[-3000:]}")
        with open(rec) as f:
            recs[name] = json.load(f)
        recs[name]["sha256_equal"] = file_digest(out)[0] == want_sha
        os.remove(rec)
        os.remove(out)
    files = sorted(os.listdir(trace_dir))
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    for rec in recs.values():
        rec["reads_per_s"] = sizes.queries / rec["wall_s"]
    res = {"part": "c", **{f"{k}_{x}": recs[k][x] for k in recs
                           for x in ("rc", "wall_s", "reads_per_s", "stage_s",
                                     "launches", "sha256_equal")},
           "trace_files": files,
           "trace_bytes": os.path.getsize(os.path.join(trace_dir, files[0])),
           "events": len(events), "kernel_events": len(kernels),
           "port_kernel_events": {k: sum(k in name for name in kernels)
                                  for k in ("min2", "compact", "kstats")},
           "card": card}
    log("layouts", **res)
    if (any(r["rc"] != 0 or not r["sha256_equal"] for r in recs.values())
            or len(files) != 1 or not res["port_kernel_events"]["min2"]):
        raise AssertionError(f"layouts (c): {res}")
    log("layouts", seconds=time.perf_counter() - t0, card=card)


# Phase 13: the wide route (windows of 2^25 bp, where not even one 64-row
# tile packs a 31-bit key) and the exact plain products past 2^24 bp.
# Its data is made on the card from the seed, and every FASTA line and
# expected output line is spelled there: a host lookup of 2^25 codes
# takes ~0.1 s a row.
WIDE_L = 1 << 25
WIDE_ROWS = 128
WIDE_READS, WIDE_KMODE_READS = 16, 8
WIDE_MAX_SUBS, WIDE_DIV = 3000, 2000
WIDE_CLUSTER, WIDE_CLUSTER_DIV = 48, 1000
EXACT_L = 3 << 23  # 25,165,824 bp: 1.5 x 2^24, the packed-key routes
EXACT_ROWS, EXACT_READS, EXACT_CLUSTER = 64, 8, 32
EXACT_SUBS = 1001  # odd: the direct check's dot L - 1001 is odd
DIST_BLOCK_SOURCE = "smafa_tpu_torch/csrc/dist_block.cu"
# not Pallas: the XLA block_distances of topm_scan (:226) and min_scan (:1329)
DIST_BLOCK_REPLACES = "smafa_tpu/ops/distance.py:184"


class CardRows:
    """Rows of letter codes (0-3 ACGT, 4 N) made and spelled on the card
    from one seeded generator."""

    def __init__(self, dev, seed: int):
        self.dev = dev
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.lut = torch.tensor(list(b"ACGTN"), dtype=torch.uint8, device=dev)

    def random(self, n: int, L: int) -> torch.Tensor:
        """n random ACGT rows of L bp."""
        return torch.randint(0, 4, (n, L), dtype=torch.uint8, device=self.dev,
                             generator=self.gen)

    def substitute(self, row: torch.Tensor, subs: int) -> torch.Tensor:
        """A copy of row with up to ``subs`` substitutions (positions
        drawn with replacement)."""
        out = row.clone()
        pos = torch.randint(0, row.shape[0], (subs,), device=self.dev,
                            generator=self.gen)
        shift = torch.randint(1, 4, (subs,), dtype=torch.uint8,
                              device=self.dev, generator=self.gen)
        out[pos] = (out[pos] + shift) % 4
        return out

    def ascii(self, row: torch.Tensor) -> bytes:
        """The row's letters."""
        return self.lut[row.long()].cpu().numpy().tobytes()

    def write_fasta(self, path: str, rows: torch.Tensor, prefix: str) -> None:
        """One record a row."""
        with open(path, "wb") as f:
            for i in range(rows.shape[0]):
                f.write(f">{prefix}{i}\n".encode())
                f.write(self.ascii(rows[i]))
                f.write(b"\n")


def card_distances(db_t: torch.Tensor, q_t: torch.Tensor) -> np.ndarray:
    """int64 [nq, n] Hamming distances on the card by code comparison (N
    against N a match), a db row at a time."""
    out = torch.empty((q_t.shape[0], db_t.shape[0]), dtype=torch.int64,
                      device=q_t.device)
    for w in range(db_t.shape[0]):
        out[:, w] = (q_t != db_t[w]).sum(dim=1)
    return out.cpu().numpy()


def expected_query(rows: CardRows, dist: np.ndarray, db_t: torch.Tensor,
                   k: int | None, max_div: int | None,
                   limit: int | None) -> tuple[str, int]:
    """(sha256, lines) of the reference's output from the brute-force
    distances: best-hit (lib.rs:296-313) or K-mode (lib.rs:241-295) with
    --limit-per-sequence runs over identical rows."""
    import hashlib

    h, lines = hashlib.sha256(), 0
    n = dist.shape[1]
    for r, d in enumerate(dist):
        if k is None:
            hits = np.nonzero(d == d.min())[0]
            if max_div is not None and d.min() > max_div:
                hits = hits[:0]
        else:
            order = np.lexsort((np.arange(n), d))
            cutoff = d.max() if k > n else d[order[k - 1]]
            eff = cutoff if max_div is None else min(cutoff, max_div)
            hits = order[d[order] <= eff]
        run, last = 0, None
        for i in hits.tolist():
            if limit is not None:
                same = last is not None and torch.equal(db_t[i], db_t[last])
                run = run + 1 if same else 1
                last = i
                if run > limit:
                    continue
            h.update(f"{r}\t{i}\t{int(d[i])}\t".encode())
            h.update(rows.ascii(db_t[i]))
            h.update(b"\n")
            lines += 1
    return h.hexdigest(), lines


def expected_cluster(rows: CardRows, rec_t: torch.Tensor,
                     max_div: int) -> tuple[str, int, int]:
    """(sha256, lines, centroids) of the reference's greedy clustering
    (cluster.rs:13-94) on the card: exact duplicates print nothing, a
    record joins the lowest-index centroid at the min distance within
    max_div, else founds one."""
    import hashlib

    h, firsts, cents, lines = hashlib.sha256(), [], [], 0
    for j in range(rec_t.shape[0]):
        if any(torch.equal(rec_t[j], rec_t[u]) for u in firsts):
            continue
        firsts.append(j)
        best = j
        if cents:
            d = torch.stack([(rec_t[c] != rec_t[j]).sum() for c in cents])
            m = int(d.argmin())  # the first among equal minima
            if int(d[m]) <= max_div:
                best = cents[m]
        if best == j:
            cents.append(j)
        h.update(rows.ascii(rec_t[j]) + b"\t" + rows.ascii(rec_t[best]) + b"\n")
        lines += 1
    return h.hexdigest(), lines, len(cents)


def wide_query_runs(cli, query_mod, select_mod, mods: dict, rows: CardRows,
                    db: str, runs: list, dist: dict, db_t, tmp: str,
                    part: str, card: str) -> list[dict]:
    """Each (name, reads file, flags, env) query through the CLI: the
    kernels' counts set to 0 just before and read just after, the runner
    built, the sha256 against the brute force's expected bytes."""
    made, make = [], select_mod.make_runner
    out_path = os.path.join(tmp, "wide.tsv")
    done = []
    for name, q_fa, flags, env in runs:
        k = (int(flags[flags.index("--max-num-hits") + 1])
             if "--max-num-hits" in flags else None)
        md = (int(flags[flags.index("--max-divergence") + 1])
              if "--max-divergence" in flags else None)
        lim = (int(flags[flags.index("--limit-per-sequence") + 1])
               if "--limit-per-sequence" in flags else None)
        want_sha, want_lines = expected_query(rows, dist[q_fa], db_t, k, md,
                                              lim)
        saved = {v: os.environ.get(v) for v in env}
        os.environ.update(env)
        select_mod.make_runner = lambda *a: made.append(make(*a)) or made[-1]
        for mod in mods.values():
            mod.launches = 0
        try:
            rc, wall, timers = cli_query(
                cli, query_mod, ["query", "-d", db, "-q", q_fa, *flags,
                                 "-o", out_path, "--quiet"])
        finally:
            select_mod.make_runner = make
            for v, val in saved.items():
                if val is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = val
        launches = {m: mod.launches for m, mod in mods.items()}
        sha, lines = file_digest(out_path)
        os.remove(out_path)
        runner = made.pop()
        res = {"part": part, "run": name, "flags": flags, "env": env,
               "rc": rc, "wall_s": wall, "stage_s": timers.seconds,
               "hit_lines": lines, "expected_lines": want_lines,
               "sha256": sha, "sha256_equal": sha == want_sha,
               "runner": type(runner).__name__,
               "tier": getattr(runner, "tier", None),
               "n_slabs": getattr(runner, "n_slabs", None),
               "h2d_s": (runner.h2d_seconds()
                         if hasattr(runner, "h2d_seconds") else None),
               "h2d_bytes": getattr(runner, "h2d_bytes", None),
               "fill_s": getattr(runner, "fill_s", None),
               "launches": launches, "card": card}
        log("wide_windows", **res)
        if rc != 0 or sha != want_sha:
            raise AssertionError(f"wide_windows ({part}) {name}: {res}")
        done.append(res)
    return done


def wide_cluster_run(cli, cluster_mod, mods: dict, rows: CardRows,
                     rec_t: torch.Tensor, tmp: str, part: str,
                     card: str) -> dict:
    """``cluster -d WIDE_CLUSTER_DIV`` of the records ``rec_t`` through
    the CLI against the greedy oracle on the card; the kernels' counts
    set to 0 just before and read just after."""
    inp, out = os.path.join(tmp, "cl.fna"), os.path.join(tmp, "cl.tsv")
    rows.write_fasta(inp, rec_t, "c")
    want_sha, want_lines, n_cent = expected_cluster(rows, rec_t,
                                                    WIDE_CLUSTER_DIV)
    for mod in mods.values():
        mod.launches = 0
    rc, wall, timers, _shapes = cluster_cli(
        cli, cluster_mod, ["cluster", "-i", inp, "-d", str(WIDE_CLUSTER_DIV),
                           "-o", out, "--quiet"])
    launches = {m: mod.launches for m, mod in mods.items()}
    sha, lines = file_digest(out)
    os.remove(inp)
    os.remove(out)
    res = {"part": part, "run": "cluster", "records": rec_t.shape[0],
           "L": rec_t.shape[1], "rc": rc, "wall_s": wall,
           "stage_s": timers.seconds, "lines": lines,
           "expected_lines": want_lines, "centroids": n_cent,
           "sha256": sha, "sha256_equal": sha == want_sha,
           "launches": launches, "card": card}
    log("wide_windows", **res)
    if rc != 0 or sha != want_sha:
        raise AssertionError(f"wide_windows ({part}) cluster: {res}")
    return res


def near_duplicates(rows: CardRows, rng, L: int, n: int,
                    groups: int) -> torch.Tensor:
    """n records of L bp in ``groups`` near-duplicate groups: a group's
    base and copies of it with 0-1,500 substitutions (0: an exact
    duplicate), in a seeded order."""
    bases = rows.random(groups, L)
    subs = [0, 200, 700, 1100, 1500]
    return torch.stack([
        rows.substitute(bases[g], subs[int(rng.integers(0, len(subs)))])
        for g in rng.permutation(np.arange(n) % groups)])


def makedb_cli(cli, rows: CardRows, codes_t: torch.Tensor, tmp: str,
               name: str) -> tuple[str, float, float]:
    """codes_t written as FASTA and built by ``makedb --format native``
    through the CLI: (db path, write seconds, makedb seconds)."""
    fa, db = os.path.join(tmp, f"{name}.fna"), os.path.join(tmp, name)
    t0 = time.perf_counter()
    rows.write_fasta(fa, codes_t, "w")
    t1 = time.perf_counter()
    if cli.main(["makedb", "-i", fa, "-d", db, "--format", "native",
                 "--quiet"]) != 0:
        raise AssertionError(f"wide_windows: makedb of {name} failed")
    os.remove(fa)
    return db, t1 - t0, time.perf_counter() - t1


def library_block_ms(q_emb: torch.Tensor, emb: torch.Tensor,
                     zc: torch.Tensor, L: int, ref: torch.Tensor,
                     card: str) -> float | None:
    """dist_block's library_ms: the same block by one cuBLASLt int8
    product, ``L - torch._int_mm(q, emb.T) - zc`` (m > 16, so the batch
    padded to 32 rows; the port never calls it), held exactly to the
    plain version and timed by CUDA events; None, with the error logged,
    where cuBLASLt refuses the shape."""
    b = q_emb.shape[0]
    q32 = torch.nn.functional.pad(q_emb, (0, 0, 0, max(0, 32 - b)))

    def library():
        return L - torch._int_mm(q32, emb.T)[:b] - zc

    try:
        err = int((library() - ref).abs().max())
        ms = time_ms(library, 5)
    except RuntimeError as e:
        log("library_time", kernel="dist_block", call="torch._int_mm",
            B=b, W=emb.shape[0], EP=emb.shape[1], error=str(e)[:400],
            card=card)
        return None
    log("library_time", kernel="dist_block", call="torch._int_mm", B=b,
        padded_B=q32.shape[0], W=emb.shape[0], EP=emb.shape[1],
        max_abs_err=err, ms=ms, card=card)
    if err:
        raise AssertionError(f"torch._int_mm's block differs from the "
                             f"plain version: {err}")
    return ms


def exact_products(rows: CardRows, D, L: int, card: str) -> dict:
    """The repaired plain product on the card: ``distances`` of a query
    against a copy of it with EXACT_SUBS (odd) substitutions, whose dot
    (L - EXACT_SUBS, no N) is odd and above 2^24, which no float32
    holds, and against a random row with N, held to code comparison;
    the product taken the old way, one float32 product over all
    columns, is off at the first pair (the check tells the two apart)."""
    dev = rows.dev
    q = torch.randint(1, 5, (1, L), dtype=torch.uint8, device=dev,
                      generator=rows.gen)
    d = torch.cat([q, torch.randint(0, 5, (1, L), dtype=torch.uint8,
                                    device=dev, generator=rows.gen)])
    pos = torch.randperm(L, device=dev, generator=rows.gen)[:EXACT_SUBS]
    d[0, pos] = d[0, pos] % 4 + 1  # another base: distinct positions
    want = (q != d).sum(dim=1, dtype=torch.int32).unsqueeze(0)
    qe = D.expand_embed_query(q, L)
    de, zc = D.expand_embed_db(d, L)
    dot = L - int(want[0, 0]) - int(zc[0])
    got = D.distances(qe, de, zc, L)
    old = L - (qe.float() @ de.float().T).to(torch.int32) - zc.unsqueeze(0)
    res = {"part": "c", "run": "distances", "L": L,
           "dot": dot, "expected": want.tolist(), "got": got.tolist(),
           "max_abs_err": int((got - want).abs().max()),
           "old_product": old.tolist(),
           "old_product_err": int((old - want).abs().max()), "card": card}
    log("wide_windows", **res)
    if dot % 2 == 0 or dot <= 1 << 24:
        raise AssertionError(f"exact_products: dot {dot} is not odd past "
                             f"2^24")
    if res["max_abs_err"] or not res["old_product_err"]:
        raise AssertionError(f"exact_products: {res}")
    return res


def wide_windows(sizes, cli, query_mod, cluster_mod, select_mod, D, mods,
                 dev, tmp: str, rng, card: str) -> dict:
    """Phase 13. (a) A db of WIDE_ROWS windows of 2^25 bp (rows 0-1 and
    2-4 identical, rows 5-7 with runs of N), written as FASTA and built
    by ``makedb`` through the CLI: no 64-row tile packs a key, so query
    takes the wide route (``WideRunner``, the dist_block kernel). 16 reads
    with 0-3,000 substitutions off db rows (some off rows 0 and 2, one a
    copy of an N-run row) and two random: best-hit with and without
    --max-divergence 2000, K = 3 on 8 reads with and without
    --limit-per-sequence 1, and best-hit again under a forced stream
    layout with the card's memory cut to 1.2 x the twin (the slab tier,
    batches cut by bytes), each sha256 equal to a brute force on the
    card. dist_block held exactly to its plain version at 16 x 128 and
    timed beside its bound and one torch._int_mm of the block. (b) cluster of 48 records of 2^25 bp in
    near-duplicate groups at -d 1000 through the CLI (the wide centroid
    scan) against a greedy oracle on the card. (c) 64 windows of
    25,165,824 bp (1.5 x 2^24, past float32's exact integers, on the
    packed-key routes): ``distances`` held to code comparison at a pair
    whose dot is odd and above 2^24 (``exact_products``), best-hit on 8
    reads against the brute force, and
    a cluster of 32 records, whose resolve takes the plain distance
    products, against the oracle. Returns dist_block's timing and its
    launches on (a)'s best-hit run."""
    from smafa_tpu_torch.ops import dist_block as DB

    t0 = time.perf_counter()
    all_mods = {**mods, "dist_block": DB}
    rows = CardRows(dev, int(rng.integers(2**62)))
    # (a)
    L, n = WIDE_L, WIDE_ROWS
    db_t = rows.random(n, L)
    db_t[1] = db_t[0]
    db_t[3] = db_t[4] = db_t[2]
    for r in (5, 6, 7):
        for _ in range(3):  # runs of 1,024 to 131,072 N at 2^25 bp
            ln = int(rng.integers(max(1, L >> 15), max(2, L >> 8)))
            a = int(rng.integers(0, L - ln))
            db_t[r, a:a + ln] = 4
    src = [0, 0, 2, 2, 6] + rng.integers(0, n, WIDE_READS - 7).tolist()
    subs = [0, 500, 1500, 2500, 0] + rng.integers(
        0, WIDE_MAX_SUBS + 1, WIDE_READS - 7).tolist()
    q_t = torch.cat([torch.stack([rows.substitute(db_t[s], k)
                                  for s, k in zip(src, subs)]),
                     rows.random(2, L)])
    db, write_s, makedb_s = makedb_cli(cli, rows, db_t, tmp, "wide_db")
    q_fa, q8_fa = (os.path.join(tmp, f"wide_q{k}.fna")
                   for k in (WIDE_READS, WIDE_KMODE_READS))
    rows.write_fasta(q_fa, q_t, "r")
    rows.write_fasta(q8_fa, q_t[:WIDE_KMODE_READS], "r")
    t1 = time.perf_counter()
    dist = card_distances(db_t, q_t)
    dist = {q_fa: dist, q8_fa: dist[:WIDE_KMODE_READS]}
    log("wide_windows", part="a", db_rows=n, L=L, reads=WIDE_READS,
        write_db_fasta_s=write_s, makedb_s=makedb_s,
        brute_force_s=time.perf_counter() - t1,
        min_dist=[int(x) for x in dist[q_fa].min(axis=1)], card=card)
    k3 = ["--max-num-hits", "3"]
    # a card of 1.2 x the twin (20.6 GB): the twin passes 0.75 of it
    twin = n * (D.embed_width(L) + 4)
    cut = {"SMAFA_TPU_LAYOUT": "stream", "SMAFA_TPU_HBM_BYTES": str(twin * 6 // 5)}
    runs = [("best", q_fa, [], {}),
            ("best_div", q_fa, ["--max-divergence", str(WIDE_DIV)], {}),
            ("k3", q8_fa, k3, {}),
            ("k3_limit1", q8_fa, [*k3, "--limit-per-sequence", "1"], {}),
            ("best_stream_cut", q_fa, [], cut)]
    res = wide_query_runs(cli, query_mod, select_mod, all_mods, rows, db,
                          runs, dist, db_t, tmp, "a", card)
    for r in res:
        tier = "slabs" if r["run"] == "best_stream_cut" else "resident"
        if (r["runner"], r["tier"]) != ("WideRunner", tier):
            raise AssertionError(f"wide_windows (a): the wide route did not "
                                 f"serve: {r}")
    main_launches = res[0]["launches"]["dist_block"]
    if main_launches < 1 or any(v for m, v in res[0]["launches"].items()
                                if m != "dist_block"):
        raise AssertionError(f"wide_windows (a): launches {res[0]}")
    for f in (db, q_fa, q8_fa):
        os.remove(f)

    # dist_block exact and timed at (a)'s main shape: 16 reads x 128 rows
    emb, zc = D.embed_db(db_t, L, n)
    del db_t
    q_emb = D.expand_embed_query(q_t, L)
    del q_t
    got = DB.dist_block(q_emb, emb, zc, L)
    ref = D.dist_block_reference(q_emb, emb, zc, L)
    err = int((got - ref).abs().max())
    log("kernel_parity", kernel="dist_block", L=L, B=WIDE_READS, W=n,
        splits=DB.split_k(WIDE_READS, n, emb.shape[1], torch.cuda.
                          get_device_properties(dev).multi_processor_count),
        max_abs_err=err, card=card)
    if err:
        raise AssertionError(f"dist_block differs from its plain version: "
                             f"{err}")
    ms = time_ms(lambda: DB.dist_block(q_emb, emb, zc, L), 5)
    plain_ms = time_ms(lambda: D.dist_block_reference(q_emb, emb, zc, L), 1)
    timing = log_time("dist_block", L, WIDE_READS, n, ms, plain_ms,
                      bound(WIDE_READS, n, L, emb.shape[1],
                            WIDE_READS * n * 4), cell="wide_windows",
                      card=card)
    timing["max_abs_err"] = err
    timing["library_ms"] = library_block_ms(q_emb, emb, zc, L, ref, card)
    del got, ref, q_emb, emb, zc

    # (b)
    wide_cluster_run(cli, cluster_mod, all_mods, rows,
                     near_duplicates(rows, rng, L, WIDE_CLUSTER, 12), tmp,
                     "b", card)

    # (c)
    L = EXACT_L
    exact_products(rows, D, L, card)
    db_t = rows.random(EXACT_ROWS, L)
    db_t[1] = db_t[0]
    src = [0, 1] + rng.integers(0, EXACT_ROWS, EXACT_READS - 2).tolist()
    q_t = torch.stack([rows.substitute(db_t[s], int(rng.integers(
        0, WIDE_MAX_SUBS))) for s in src])
    db, _, _ = makedb_cli(cli, rows, db_t, tmp, "exact_db")
    rows.write_fasta(q_fa, q_t, "r")
    (r,) = wide_query_runs(cli, query_mod, select_mod, all_mods, rows, db,
                           [("best", q_fa, [], {})],
                           {q_fa: card_distances(db_t, q_t)}, db_t, tmp, "c",
                           card)
    if r["runner"] != "SlabStreamRunner" or r["launches"]["min2"] < 1:
        raise AssertionError(f"wide_windows (c): {r}")
    del db_t, q_t
    for f in (db, q_fa):
        os.remove(f)
    wide_cluster_run(cli, cluster_mod, all_mods, rows,
                     near_duplicates(rows, rng, L, EXACT_CLUSTER, 8), tmp,
                     "c", card)
    log("wide_windows", seconds=time.perf_counter() - t0, card=card)
    return {**timing, "launches": main_launches}


def run_phases(seed: int, after=None) -> tuple[list, str]:
    """Phases 0-13 in this process; ``after(phase)``, when given, is
    called after each (tools/torch_trace_probe.py --after-phases traces
    there). Returns the kernels' summary and the card's nvidia-smi
    line."""
    after = after or (lambda phase: None)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from smafa_tpu_torch import cli
    from smafa_tpu_torch.engine import cluster as cluster_mod, query as query_mod
    from smafa_tpu_torch.ops import _build, compact as compact_mod
    from smafa_tpu_torch.ops import distance as D, keys as K, min2 as min2_mod
    from smafa_tpu_torch.ops import hist as hist_mod, kstats as ks_mod
    from smafa_tpu_torch.ops import min_count as mc_mod
    from smafa_tpu_torch.parallel import hitops
    from smafa_tpu_torch.parallel import select as select_mod, slab as slab_mod

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions exact
    card = nvidia_smi()
    log("device", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.load()
    # ptxas -v of each source: registers, stack and spills of each
    # kernel, and any C75xx line (a wgmma serialised)
    ptxas = {f"{src}_ptxas": [
        line.strip() for line in _build.compile_log.get(
            f"{src}.cu", "not measured (library already built)").splitlines()
        if "entry function" in line or "spill" in line or "Used" in line
        or "C75" in line or "not measured" in line]
        for src in ("min2", "compact", "kstats", "min_count", "dist_block",
                    "hist")}
    log("build", seconds=time.perf_counter() - t0,
        library=str(_build.library_path().name), **ptxas,
        **warpgroup_sass(_build))

    from smafa_tpu_torch import native

    t0 = time.perf_counter()
    native.load()  # a failed build raises, and fails the run
    gxx = subprocess.run([native.CXX, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    log("native_build", gxx=gxx.splitlines()[0],
        seconds=time.perf_counter() - t0, library=native.library_path().name)
    after("build")

    # the query batch the CLI picks for this db (engine.query._auto_batch)
    sizes = smoke_sizes(query_mod)
    rng = np.random.default_rng(seed)
    # the K-mode phases draw from a stream of their own, so the others
    # see the same data as before K-mode was added
    rng_k = np.random.default_rng([seed, 4])
    rng_m = np.random.default_rng([seed, 5])  # min2's shapes added later
    rng_c = np.random.default_rng([seed, 6])  # compact_mask's, likewise
    rng_s = np.random.default_rng([seed, 7])  # kstats' split shapes
    rng_n = np.random.default_rng([seed, 8])  # min_count's split shapes
    dev = torch.device("cuda")
    timing = {"min2": kernel_parity(sizes, dev, D, K, min2_mod, rng, rng_m)}
    timing["compact_mask"] = compact_parity(sizes, dev, D, compact_mod, rng,
                                            rng_c)
    timing["min_count"] = min_count_parity(sizes, dev, D, K, mc_mod, min2_mod,
                                           rng, rng_n)
    timing["kstats"] = kstats_parity(sizes, dev, D, K, ks_mod, min2_mod, rng_k,
                                     rng_s)
    timing["hist"] = hist_parity(sizes, dev, D, K, hist_mod, ks_mod,
                                 np.random.default_rng([seed, 16]))
    after("kernel_parity")
    with tempfile.TemporaryDirectory(prefix="smafa_smoke_") as tmp:
        e2e, codes, db = end_to_end(sizes, cli, query_mod, min2_mod,
                                    compact_mod, rng, tmp)
        after("end_to_end")
        kmode_compact_parity(sizes, dev, D, K, ks_mod, compact_mod, hitops,
                             codes, rng_k)
        kmode = kmode_end_to_end(sizes, cli, query_mod, K, ks_mod,
                                 compact_mod, hist_mod, codes, db, tmp,
                                 rng_k)
        after("kmode_end_to_end")
        clu, cluster_inp = cluster_end_to_end(
            sizes, cli, cluster_mod, mc_mod, D, K, dev, rng,
            np.random.default_rng([seed, 9]), tmp)
        after("cluster_end_to_end")
        host_parity(sizes, query_mod, cluster_mod, e2e, cluster_inp, codes)
        del codes
        after("host_parity")
        resume_phase(sizes, cli, query_mod, cluster_mod, dev, e2e, db,
                     cluster_inp, tmp)
        after("resume")
        stream_mods = {"min2": min2_mod, "compact_mask": compact_mod,
                       "kstats": ks_mod, "hist": hist_mod}
        stream_parity(sizes, cli, query_mod, select_mod, stream_mods, e2e,
                      kmode, db, tmp, card)
        stream_kept = stream_full(sizes, cli, query_mod, select_mod,
                                  slab_mod, stream_mods, dev, tmp,
                                  np.random.default_rng([seed, 10]), card)
        after("stream")
        long_windows(sizes, cli, query_mod, select_mod, slab_mod, hitops,
                     stream_mods, D, K, min2_mod, mc_mod, dev, tmp,
                     np.random.default_rng([seed, 11]), card)
        after("long_windows")
        cluster_spans(sizes, cli, cluster_mod, mc_mod, D, K, min2_mod, clu,
                      cluster_inp, dev, tmp, np.random.default_rng([seed, 12]),
                      card)
        after("cluster_spans")
        mp_kept = multiprocess(sizes, cli, query_mod, cluster_mod,
                               {**stream_mods, "min_count": mc_mod}, dev, tmp,
                               np.random.default_rng([seed, 13]), card,
                               stream_kept, cluster_inp)
        after("multiprocess")
        layouts(sizes, cli, query_mod, stream_mods, dev, tmp,
                np.random.default_rng([seed, 14]), card, mp_kept, e2e, db)
        after("layouts")
        timing["dist_block"] = wide_windows(
            sizes, cli, query_mod, cluster_mod, select_mod, D,
            {**stream_mods, "min_count": mc_mod}, dev, tmp,
            np.random.default_rng([seed, 15]), card)
        after("wide_windows")

    launches = {"min2": e2e["launches"]["min2"],
                "compact_mask": e2e["launches"]["compact_mask"],
                "min_count": clu["launches"]["min_count"],
                "kstats": kmode["a"]["launches"]["kstats"],
                "hist": kmode["a"]["hist_launches"],
                "dist_block": timing["dist_block"]["launches"]}
    routes = {"min2": (MIN2_SOURCE, MIN2_REPLACES),
              "compact_mask": (COMPACT_SOURCE, COMPACT_REPLACES),
              "min_count": (MIN_COUNT_SOURCE, MIN_COUNT_REPLACES),
              "kstats": (KSTATS_SOURCE, KSTATS_REPLACES),
              "hist": (HIST_SOURCE, HIST_REPLACES),
              "dist_block": (DIST_BLOCK_SOURCE, DIST_BLOCK_REPLACES)}
    # library_ms: no single PyTorch call computes any of the five scans'
    # per-row reductions (hist's per-row histogram among them) over a
    # distance matrix that is never materialised (torch._int_mm would
    # write B x W int32: 128 GiB at min2's shape); dist_block's block is
    # one torch._int_mm and an elementwise epilogue (library_block_ms).
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": timing[name]["max_abs_err"],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name].get("library_ms")}
        for name, (src, rep) in routes.items()]
    return kernels, card


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank_worker(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated db, query and threshold")
    seed = ap.parse_args().seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    kernels, card = run_phases(seed)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
