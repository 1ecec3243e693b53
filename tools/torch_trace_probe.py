"""Which kernel events a ``maybe_trace`` trace keeps, on one card, when
the process has run profiler sessions before.

In one process, on a seeded tie-heavy db (65,536 windows of 60 bp, every
window one of 8,192 base rows) and three batches of 2,048 reads, each
scenario runs under ``smafa_tpu_torch.utils.profiling.maybe_trace``
(``SMAFA_TPU_TRACE_DIR`` set to a temporary directory) and reads its
Chrome trace back:

- ``pipelined`` (run first, then again): best-hit through ``ScanRunner``
  with one batch in flight, as the query engine runs it: min2 on the
  runner's side stream, compact_mask on the current stream;
- ``min2_current`` / ``min2_side``: the min2 wrapper called directly,
  three times, on the current stream / inside ``torch.cuda.stream`` of a
  new stream;
- ``pipelined_after_cuda_only``: ``pipelined`` after a
  ``torch.profiler.profile`` session with CUDA activity only (as
  chip_smoke.py's ``device_ms`` takes them);
- ``after_<n>_kernels``: ``pipelined`` after n (10^4, 10^5, 10^6)
  one-element CUDA kernels launched with no session open, as a long
  process runs between traces; then ``..._again`` right after it; then
  ``after_10^6_kernels_cuda_only``: the 10^6 kernels, an empty
  CUDA-only session, then ``pipelined``.

Prints one JSON line a scenario: the port's launches in the block, the
trace's kernel events of each port kernel and in all, the kernel events
per stream, the spread of each kernel's start minus its launch's
(``launch_to_start_us``: negative means the card's timestamps run ahead
of the host's), and the warning ``maybe_trace`` logged (null if none);
then the card's name and power limit. Run from the repository root:
``python3 tools/torch_trace_probe.py``.

``--after-phases OUT``: instead, runs chip_smoke.py's phases in this
process (``chip_smoke.run_phases``) and ``pipelined`` traced after each,
to find the phase after which a trace loses kernel events; each line
adds the phase and the process's seconds so far, and the lines also go
to the file OUT (chip_smoke.py's own lines fill the standard output).

``--bisect-cli OUT``: instead, splits chip_smoke.py's phase 3 (the first
in-process CLI run, after which a trace loses events) into its parts,
each in a fresh process of this script (``--cli-step STEP``) that traces
``pipelined`` before and after that part alone, on phase 3's data
(2^20 random 60 bp windows, 65,536 reads): ``none`` (the control),
``mem_get_info`` (the layout choice's ``torch.cuda.mem_get_info``),
``makedb`` (CLI ``makedb --format native`` of the FASTA), ``query``
(CLI best-hit ``query --quiet`` on a db saved without the CLI),
``query_no_native`` (the same with SMAFA_TPU_NO_NATIVE=1: no native
parse and emit threads), ``runner`` (the query's ``ScanRunner`` and
one pipelined best-hit pass over its batches, no CLI), ``makedb_query``
(the two CLI runs in turn, as phase 3 runs them),
``session_makedb_query`` (the same after a CUDA-only profiler session,
as phase 2's ``device_ms`` takes them), and ``parity_makedb_query`` and
``parity_query``: chip_smoke.py's kernel parity phase first (its four
kernels' parity and timing functions, seed 0, before the first trace),
then both CLI runs or the query alone. One line a step, also to the
file OUT.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from smafa_tpu_torch.ops import keys as K  # noqa: E402
from smafa_tpu_torch.ops import min2 as M  # noqa: E402
from smafa_tpu_torch.parallel.runner import ScanRunner  # noqa: E402
from smafa_tpu_torch.utils import profiling  # noqa: E402

L, W, B, BATCHES = 60, 1 << 16, 2048, 3


class Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.msgs = []

    def emit(self, record):
        self.msgs.append(record.getMessage())


def data(dev):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, (W // 8, L), dtype=np.uint8)
    codes = base[rng.integers(0, W // 8, W)]
    q = codes[rng.integers(0, W, BATCHES * B)].copy()
    mut = rng.random(q.shape) < 0.02
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    return ScanRunner(codes, L, dev), np.split(q, BATCHES)


def pipelined(runner, qs):
    pending = None
    for b in [*qs, None]:
        current = None if b is None else (b, runner.min_count_async(b))
        if pending is not None:
            runner.best_hit(pending[0], handle=pending[1])
        pending = current
    torch.cuda.synchronize()


def min2_calls(runner, qs, stream):
    q_padded = K.pad_batch(qs[0], multiple=1, minimum=16)[0]
    q_emb = runner._embed_queries(q_padded)
    with torch.cuda.stream(stream):
        for _ in range(3):
            M.min2(q_emb, runner.db_emb, runner.zc, L, runner.shift,
                   with_count=True)
    torch.cuda.synchronize()


def scenario(name, fn, trace_root, warn):
    trace_dir = os.path.join(trace_root, name)
    os.environ["SMAFA_TPU_TRACE_DIR"] = trace_dir
    before = profiling._launches()
    warn.msgs.clear()
    with profiling.maybe_trace(cuda=True):
        fn()
    del os.environ["SMAFA_TPU_TRACE_DIR"]
    (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    streams = {}
    for e in kernels:
        s = str(e.get("args", {}).get("stream"))
        streams[s] = streams.get(s, 0) + 1
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    lag = [e["ts"] - launched[c] for e in kernels
           if (c := e.get("args", {}).get("correlation")) in launched]
    return {"scenario": name,
            "launches": {k: n - before[k]
                         for k, n in profiling._launches().items()},
            "kernel_events": {k: sum(f"::{k}_" in e.get("name", "")
                                     for e in kernels)
                              for k in before},
            "all_kernel_events": len(kernels), "streams": streams,
            "launch_to_start_us": [min(lag), statistics.median(lag),
                                   max(lag)] if lag else None,
            "warning": warn.msgs[0] if warn.msgs else None}


def after_phases(seed: int, out: str) -> None:
    """chip_smoke.py's phases in this process, ``pipelined`` traced
    before the first and after each; the lines also go to ``out``."""
    import chip_smoke

    dev = torch.device("cuda")
    warn = Warnings()
    logging.getLogger("smafa").addHandler(warn)
    runner, qs = data(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root, open(out, "w") as f:
        def probe(phase):
            res = scenario(f"after_{phase}", lambda: pipelined(runner, qs),
                           root, warn)
            res.update(phase=phase, process_s=time.perf_counter() - t0)
            print(json.dumps(res), flush=True)
            f.write(json.dumps(res) + "\n")
            f.flush()

        pipelined(runner, qs)  # builds the kernels, outside every trace
        probe("start")
        chip_smoke.run_phases(seed, after=probe)


CLI_STEPS = ("none", "mem_get_info", "makedb", "query", "query_no_native",
             "runner", "makedb_query", "session_makedb_query",
             "parity_makedb_query", "parity_query")


def parity_phase(dev) -> None:
    """chip_smoke.py's kernel parity phase (phase 2 and kstats' part of
    phase 4) in this process, as ``run_phases`` runs it at seed 0."""
    import chip_smoke
    from smafa_tpu_torch.engine import query as query_mod
    from smafa_tpu_torch.ops import compact, distance, kstats, min_count

    sizes = chip_smoke.smoke_sizes(query_mod)
    rng = np.random.default_rng(0)
    chip_smoke.kernel_parity(sizes, dev, distance, K, M, rng,
                             np.random.default_rng([0, 5]))
    chip_smoke.compact_parity(sizes, dev, distance, compact, rng,
                              np.random.default_rng([0, 6]))
    chip_smoke.min_count_parity(sizes, dev, distance, K, min_count, M, rng,
                                np.random.default_rng([0, 8]))
    chip_smoke.kstats_parity(sizes, dev, distance, K, kstats, M,
                             np.random.default_rng([0, 4]),
                             np.random.default_rng([0, 7]))


def cli_step(step: str, out: str) -> None:
    """One part of phase 3 between two traces of ``pipelined``, in this
    (fresh) process; appends its line to ``out``."""
    import chip_smoke
    from smafa_tpu_torch import cli
    from smafa_tpu_torch.core.windowset import WindowSet
    from smafa_tpu_torch.io import native_format

    dev = torch.device("cuda")
    warn = Warnings()
    logging.getLogger("smafa").addHandler(warn)
    runner, qs = data(dev)
    pipelined(runner, qs)  # builds the kernels, outside every trace
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as root:
        codes = chip_smoke.random_db(rng, 1 << 20, 60)
        q = chip_smoke.mutate(rng, codes[rng.integers(0, 1 << 20, 65536)], 6)
        db_fa, q_fa = (os.path.join(root, f) for f in ("db.fna", "q.fna"))
        db = os.path.join(root, "db.native")
        chip_smoke.write_fasta(q_fa, q, "r")
        if "makedb" in step:
            chip_smoke.write_fasta(db_fa, codes, "s")
        else:
            native_format.save(WindowSet.from_matrix(codes, 2), db)
        if step.startswith("parity_"):
            parity_phase(dev)
        before = scenario("before", lambda: pipelined(runner, qs), root, warn)
        t0 = time.perf_counter()
        if step == "session_makedb_query":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]):
                min2_calls(runner, qs, torch.cuda.current_stream())
        if step == "mem_get_info":
            torch.cuda.mem_get_info(dev)
        elif "makedb" in step:
            assert cli.main(["makedb", "-i", db_fa, "-d", db, "--format",
                             "native", "--quiet"]) == 0
        if step in ("query", "query_no_native") or step.endswith("_query"):
            if step == "query_no_native":
                os.environ["SMAFA_TPU_NO_NATIVE"] = "1"
            assert cli.main(["query", "-d", db, "-q", q_fa,
                             "--max-divergence", "5", "-o",
                             os.path.join(root, "hits.tsv"),
                             "--quiet"]) == 0
            os.environ.pop("SMAFA_TPU_NO_NATIVE", None)
        elif step == "runner":
            big = ScanRunner(codes, 60, dev)
            pipelined(big, np.array_split(q, 4))
            del big
        seconds = time.perf_counter() - t0
        after = scenario("after", lambda: pipelined(runner, qs), root, warn)
    line = {"step": step, "seconds": seconds,
            "before": before["all_kernel_events"],
            "after": after["all_kernel_events"],
            "before_port": before["kernel_events"],
            "after_port": after["kernel_events"],
            "launches": after["launches"], "warning": after["warning"]}
    print(json.dumps(line), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(line) + "\n")


def bisect_cli(out: str) -> None:
    """Each of CLI_STEPS in a process of its own (``cli_step``)."""
    open(out, "w").close()
    for step in CLI_STEPS:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--cli-step", step, out],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(json.dumps({"step": step, "rc": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
    with open(out) as f:
        sys.stdout.write(f.read())


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--after-phases", metavar="OUT",
                    help="trace after each of chip_smoke.py's phases; "
                    "the lines also go to the file OUT")
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's seed (with --after-phases)")
    ap.add_argument("--bisect-cli", metavar="OUT",
                    help="trace before and after each part of phase 3's "
                    "CLI run, each in a process of its own; the lines also "
                    "go to the file OUT")
    ap.add_argument("--cli-step", nargs=2, metavar=("STEP", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cli_step:
        cli_step(*args.cli_step)
        return 0
    if args.bisect_cli:
        bisect_cli(args.bisect_cli)
        return 0
    if args.after_phases:
        after_phases(args.seed, args.after_phases)
        return 0
    dev = torch.device("cuda")
    warn = Warnings()
    logging.getLogger("smafa").addHandler(warn)
    runner, qs = data(dev)
    pipelined(runner, qs)  # builds the kernels, outside every trace
    side = torch.cuda.Stream()
    with tempfile.TemporaryDirectory() as root:
        runs = [("pipelined", lambda: pipelined(runner, qs)),
                ("pipelined_again", lambda: pipelined(runner, qs)),
                ("min2_current",
                 lambda: min2_calls(runner, qs,
                                    torch.cuda.current_stream())),
                ("min2_side", lambda: min2_calls(runner, qs, side))]
        for name, fn in runs:
            print(json.dumps(scenario(name, fn, root, warn)), flush=True)
        with profile(activities=[ProfilerActivity.CUDA]):
            min2_calls(runner, qs, torch.cuda.current_stream())
        print(json.dumps(scenario("pipelined_after_cuda_only",
                                  lambda: pipelined(runner, qs), root,
                                  warn)), flush=True)
        x = torch.zeros(1, device=dev)
        for n, flush in ((10**4, False), (10**5, False), (10**6, False),
                         (10**6, True)):
            for _ in range(n):
                x.add_(1)
            torch.cuda.synchronize()
            name = f"after_{n}_kernels"
            if flush:
                with profile(activities=[ProfilerActivity.CUDA]):
                    pass
                name += "_cuda_only"
            print(json.dumps(scenario(name, lambda: pipelined(runner, qs),
                                      root, warn)), flush=True)
            if not flush:
                print(json.dumps(scenario(name + "_again",
                                          lambda: pipelined(runner, qs),
                                          root, warn)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip().splitlines()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
