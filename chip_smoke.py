"""Card smoke test of the PyTorch port (smafa_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
Phases, one line each:

0. device: the card's name and power limit (nvidia-smi) and the
   torch/CUDA versions; fails when no CUDA device is visible.
1. build: compiles the CUDA kernels from smafa_tpu_torch/csrc with nvcc;
   logs each source's ``ptxas -v`` (registers, spills).
2. kernel parity: each kernel against its plain PyTorch version on the
   card, exact equality (all values are integers), with both times and
   the kernel's bound (the larger of its int8 operations over 1,979
   TOP/s and its bytes over 3.35 TB/s, the H100 SXM's dense peaks).
   min_count, with and without the count, at L = 3, 60, 150, 300 over a
   live buffer, then at its split shapes, each line with its route and
   db splits (the cluster's batches B = 1, 77, 2048, 32768 against
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
   its long-window route at L = 150 (timed at 4096 x 2^20).
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
   rule (lib.rs:241-295).
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
        kmode_sample=256,
        # the query batch the CLI picks for this db
        main_batch=query_mod._auto_batch(
            types.SimpleNamespace(n_windows=db_rows)))


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
            log("kernel_parity", kernel="min2", L=L, B=b, W=n,
                splits=min2_mod.launch_plan(b, wp, ep, sms)[1],
                min_dist=min_dist, max_count=max_count, exact=True)
            if timed in ("parity", "main", "b512"):
                ms = time_ms(lambda: min2_mod.min2(q_emb, db_emb, zc, L, shift), sizes.reps)
                plain_ms = time_ms(lambda: D.min2_reference(q_emb, db_emb, zc, L, shift), 2)
                timings[timed] = log_time(
                    "min2", L, b, n, ms, plain_ms,
                    bound(b, n, L, ep, out_bytes=3 * 4 * b),
                    splits=min2_mod.launch_plan(b, wp, ep, sms)[1])
            del q_emb, got, want
        del db_emb, zc
    return {"max_abs_err": 0, **timings["main"]}


def compact_plan(compact_mod, b: int, wp: int, ep: int, dev) -> dict:
    """The route and db splits the compact_mask wrapper launches with."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route, splits = compact_mod.launch_plan(b, wp, ep, sms)
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
    route (dp4a) at L = 150, timed at 4096 x 2^20."""
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


def live_plan(min2_mod, b: int, n_valid: int, ep: int, dev) -> dict:
    """The route and db splits the min_count and kstats wrappers launch
    with (``ops/min2.py:live_plan``, over the first n_valid rows)."""
    route, splits = min2_mod.live_plan(b, n_valid, ep, min2_mod.sm_count(dev))
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
        for n_valid in (sizes.min_count_below, wp):
            min_count_check(mc_mod, D, q_emb, emb, zc, n_valid, L, shift,
                            f"L={L} n_valid={n_valid}")
        log("kernel_parity", kernel="min_count", L=L, B=1000, W=wp,
            n_valid=[sizes.min_count_below, wp], exact=True)
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
            **live_plan(min2_mod, b, n_valid, q_emb.shape[1], dev),
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
            **live_plan(min2_mod, b, w, q_emb.shape[1], dev),
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
                 where: str) -> None:
    """The kernel's (cnt, mx), held exactly to the plain version's."""
    got = ks_mod.kstats(q_emb, db_emb, zc, ts, n_valid, L_SMOKE)
    want = D.stats_reference(q_emb, db_emb, zc, ts, n_valid, L_SMOKE)
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
        return live_plan(min2_mod, b, n_valid, ep, dev)

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
                      max_div: int) -> list[str]:
    """The reference best-hit lines of one query (lib.rs:306-313)."""
    L = codes.shape[1]
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
    for i in sorted(sample.tolist()):
        want = brute_force_lines(codes, q[i], i, max_div)
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


def kmode_end_to_end(sizes, cli, query_mod, K, ks_mod, compact_mod, codes,
                     db, tmp, rng) -> dict:
    """Phase 4, K-mode query through the CLI on phase 3's db: each run's
    kernel counts set to 0 just before it and read just after; sampled
    reads checked against a brute force; the output file deleted."""
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
               "host_calls": spies.counts}
        log("kmode_end_to_end", run=name, db_rows=n, **res)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated db, query and threshold")
    seed = ap.parse_args().seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from smafa_tpu_torch import cli
    from smafa_tpu_torch.engine import cluster as cluster_mod, query as query_mod
    from smafa_tpu_torch.ops import _build, compact as compact_mod
    from smafa_tpu_torch.ops import distance as D, keys as K, min2 as min2_mod
    from smafa_tpu_torch.ops import kstats as ks_mod, min_count as mc_mod
    from smafa_tpu_torch.parallel import hitops

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions exact
    card = nvidia_smi()
    log("device", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.load()
    # ptxas -v of each source: registers, stack and spills of each kernel
    ptxas = {f"{src}_ptxas": [
        line.strip() for line in _build.compile_log.get(
            f"{src}.cu", "not measured (library already built)").splitlines()
        if "entry function" in line or "spill" in line or "Used" in line
        or "not measured" in line]
        for src in ("min2", "compact", "kstats", "min_count")}
    log("build", seconds=time.perf_counter() - t0,
        library=str(_build.library_path().name), **ptxas)

    from smafa_tpu_torch import native

    t0 = time.perf_counter()
    native.load()  # a failed build raises, and fails the run
    gxx = subprocess.run([native.CXX, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    log("native_build", gxx=gxx.splitlines()[0],
        seconds=time.perf_counter() - t0, library=native.library_path().name)

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
    with tempfile.TemporaryDirectory(prefix="smafa_smoke_") as tmp:
        e2e, codes, db = end_to_end(sizes, cli, query_mod, min2_mod,
                                    compact_mod, rng, tmp)
        kmode_compact_parity(sizes, dev, D, K, ks_mod, compact_mod, hitops,
                             codes, rng_k)
        kmode = kmode_end_to_end(sizes, cli, query_mod, K, ks_mod,
                                 compact_mod, codes, db, tmp, rng_k)
        clu, cluster_inp = cluster_end_to_end(
            sizes, cli, cluster_mod, mc_mod, D, K, dev, rng,
            np.random.default_rng([seed, 9]), tmp)
        host_parity(sizes, query_mod, cluster_mod, e2e, cluster_inp, codes)
        del codes
        resume_phase(sizes, cli, query_mod, cluster_mod, dev, e2e, db,
                     cluster_inp, tmp)

    launches = {"min2": e2e["launches"]["min2"],
                "compact_mask": e2e["launches"]["compact_mask"],
                "min_count": clu["launches"]["min_count"],
                "kstats": kmode["a"]["launches"]["kstats"]}
    routes = {"min2": (MIN2_SOURCE, MIN2_REPLACES),
              "compact_mask": (COMPACT_SOURCE, COMPACT_REPLACES),
              "min_count": (MIN_COUNT_SOURCE, MIN_COUNT_REPLACES),
              "kstats": (KSTATS_SOURCE, KSTATS_REPLACES)}
    # library_ms: no single PyTorch call computes any of these per-row
    # reductions over a distance matrix that is never materialised
    # (torch._int_mm would write B x W int32: 128 GiB at min2's shape).
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": timing[name]["max_abs_err"],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"], "library_ms": None}
        for name, (src, rep) in routes.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
