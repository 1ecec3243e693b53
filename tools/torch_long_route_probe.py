"""The four kernels past 64 bp (their long routes) on a card: each call
held exactly to its plain version, then timed by CUDA events.

Shapes (B reads x rows, L): phase 9 of chip_smoke.py at 150 bp (min2
32768 x 2,621,440, kstats 4096 x 2,621,440 at the first cutoff pass's
probes, compact_mask 2048 x 2,621,440 at the reads' K = 99 cutoffs;
min2 also at 127 bp, form (a) at 4 panels a row, whose ring holds 12
stages to 150 bp's 8),
and 300 bp and 29,903 bp (phase 12 (b)'s width) at 4096 reads for min2
and compact_mask (1024 at 29,903 bp) and 1024 for kstats x 32,768 rows;
min_count without the count at the cluster's 32768 x 32768 (150 bp) and
at phase 10 (b)'s span, 32768 x 2^22 (300 bp). Form (b)'s item order
(db split fastest when every item runs at once and the splits are at
most twice the query tiles) is also timed on each side of its rule:
compact_mask at 164 bp, 2048, 4096 and 8192 x 2,621,440 (8, 16 and 32
query tiles x 33 splits, more items than SMs), min2 at 164 bp, 4096 x
2,621,440 (16 x 8), min2 at 29,903 bp, 2048, 2560 and 3072 x 32,768 (8
x 16, 10 x 13, 12 x 11), compact_mask there at 2048 (8 x 16) and min2
at 300 bp, 2048 x 32,768 (8 x 16). The db is random codes
0-3 with a tenth of its rows copies of row 3; reads are db rows with
about 5% substitutions, the first 4 copies of row 3; all from --seed on
the card.

Default: the package of the checkout at ``--root`` (this one unless
given: the parent's tree, for a change against its parent in one call)
through its wrappers, which build its kernels; one JSON line a shape.

``--orders`` (kstats and min_count, form (b) of csrc/wg_long.cuh):
builds this checkout's csrc/kstats.cu and min_count.cu into one library
twice, from copies of csrc whose ``split_fastest_b`` returns true (db
split fastest) or false (query tile fastest), one nvcc a source and
build, all started together; then at kstats 1024 x 32,768 at 300 and 29,903 bp and
min_count 32768 x 2^22 at 300 bp times both through their C entries at
the wrapper's db splits, in turns (1, 0, 0, 1), each held exactly to the
plain version first, beside the order the library's rule
(``split_fastest_b``) picks. Prints each build's ptxas lines of the
long-route kernels.

``--probes`` (the four kernels' long routes, the K-chunked wgmma tile of
csrc/wg_long.cuh): builds this checkout's csrc/min2.cu, compact.cu,
kstats.cu and min_count.cu into one library as they are ("kernel") and
as probe builds by ``-D`` macros (``copies_only``: the copies and the
ring, no product, no epilogue; ``products_only``: the products on
whatever shared memory holds, no copy, no epilogue; ``no_epilogue``:
copies and products), one nvcc a source and build, all started
together; then at each shape times every build's C entry at the
wrapper's db splits in turns (the builds in order, then reversed), the
kernel held exactly to the plain version first. ``--splits`` also times
the kernel at 1, 8, 16, 33, 66 and 132 db splits (where the db has that
many 64-row tiles). Prints each build's ptxas lines of the long-route
kernels (any C75xx line included).

    python3 tools/torch_long_route_probe.py [--root DIR] [--orders]
        [--probes [--splits]] [--only 150 300 29903]
        [--kernels min2 kstats compact_mask min_count] [--seed N]

Needs a CUDA device (and nvcc); run from anywhere. Prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

_HERE = pathlib.Path(__file__).resolve().parent.parent

# (kernel, L, B, rows, reps)
SHAPES = [("min2", 150, 32768, 2_621_440, 3), ("kstats", 150, 4096, 2_621_440, 3),
          ("min2", 127, 32768, 2_621_440, 3),
          ("min2", 300, 4096, 32768, 5), ("kstats", 300, 1024, 32768, 5),
          ("min2", 29903, 4096, 32768, 2), ("kstats", 29903, 1024, 32768, 2),
          ("compact_mask", 150, 2048, 2_621_440, 3),
          ("compact_mask", 300, 4096, 32768, 5),
          ("compact_mask", 29903, 1024, 32768, 2),
          ("compact_mask", 164, 2048, 2_621_440, 3),
          ("min2", 164, 4096, 2_621_440, 3),
          ("min2", 29903, 2560, 32768, 2), ("min2", 29903, 3072, 32768, 2),
          ("min2", 29903, 2048, 32768, 2),
          ("compact_mask", 29903, 2048, 32768, 2),
          ("min2", 300, 2048, 32768, 5),
          ("compact_mask", 164, 4096, 2_621_440, 3),
          ("compact_mask", 164, 8192, 2_621_440, 3),
          ("min_count", 150, 32768, 32768, 5),
          ("min_count", 300, 32768, 1 << 22, 2)]
# the probe builds of the long routes: name -> -D flags
PROBE_BUILDS = {"kernel": [], "copies_only": ["-DWG_LONG_PROBE_COPIES_ONLY"],
                "products_only": ["-DWG_LONG_PROBE_PRODUCTS_ONLY"],
                "no_epilogue": ["-DWG_LONG_PROBE_NO_EPILOGUE"]}
PROBE_SOURCES = ("min2", "compact", "kstats", "min_count")
# form (b)'s item order forced: name -> the return of a patched
# split_fastest_b; the shapes it is timed at
ORDER_RULE = """  if (qtiles * S <= (int)gridDim.x) return S <= 2 * qtiles;
  return (long)min(qtiles, (int)gridDim.x) * ROWS * nkp * PANEL >
         ((long)L2_QUERY_MB << 20);"""
ORDER_BUILDS = {"split_fastest": "  return true;",
                "query_tile_fastest": "  return false;"}
ORDER_SOURCES = ("kstats", "min_count")
ORDER_SHAPES = (("kstats", 300, 1024), ("kstats", 29903, 1024),
                ("min_count", 300, 32768))
EXACT_BUILDS = ("kernel",)
SPLIT_SWEEP = (1, 8, 16, 33, 66, 132)
PEAK_INT8_OPS = 1.979e15  # H100 SXM dense int8 tensor-core peak, op/s


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def operands(torch, D, K, L: int, b: int, rows: int, seed: int, dev):
    """(db_emb, zc, q_emb, shift, ts) for one shape, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 4, (rows, L), generator=gen, device=dev,
                          dtype=torch.uint8)
    dup = torch.randint(0, rows, (rows // 10,), generator=gen, device=dev)
    codes[dup] = codes[3].clone()
    q = codes[torch.randint(0, rows, (b,), generator=gen, device=dev)].clone()
    mut = torch.rand(q.shape, generator=gen, device=dev) < 0.05
    q[mut] = torch.randint(0, 4, (int(mut.sum()),), generator=gen, device=dev,
                           dtype=torch.uint8)
    q[:4] = codes[3]
    wp = -(-rows // D.WP_MULTIPLE) * D.WP_MULTIPLE
    emb, zc = D.embed_db(codes, L, wp)
    del codes
    q_emb = D.expand_embed_query(q, L)
    P = K.KSTATS_PROBES
    ts = torch.tensor([[L * i // P] for i in range(1, P)] + [[L]],
                      dtype=torch.int32, device=dev).expand(P, b).contiguous()
    return emb, zc, q_emb, K.packing_shift(L, wp), ts


def events_ms(torch, fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(b: int, rows: int, L: int) -> float:
    return 2 * b * rows * 4 * L / PEAK_INT8_OPS * 1e3


def plan(M, C, b, rows, ep, dev, kernel):
    """(route, splits) of the wrapper's launch: kstats' and min_count's
    ``live_plan`` (at the kernel's item cost, in a tree whose plan takes
    one), min2's and compact_mask's ``kernel_plan``. In a tree without
    ``kernel_plan`` min2 and compact_mask took ``launch_plan``."""
    if kernel in ("min2", "compact_mask"):
        mod = C if kernel == "compact_mask" else M
        if hasattr(mod, "kernel_plan"):
            return mod.kernel_plan(b, rows, ep, M.sm_count(dev))
        return M.launch_plan(b, rows, ep, M.sm_count(dev))
    args = [b, rows, ep, M.sm_count(dev)]
    if "item_steps" in inspect.signature(M.live_plan).parameters:
        args.append(M.KSTATS_ITEM_STEPS if kernel == "kstats"
                    else M.MIN_COUNT_ITEM_STEPS)
    return M.live_plan(*args)


def split_fastest(b: int, splits: int, ep: int, sms: int) -> bool:
    """csrc/wg_long.cuh split_fastest_b: form (b)'s order at b reads of
    ep bytes (32 MB: its L2_QUERY_MB)."""
    qtiles = -(-b // 256)
    if qtiles * splits <= sms:
        return splits <= 2 * qtiles
    return min(qtiles, sms) * 256 * -(-ep // 128) * 128 > 32 << 20


def run_wrappers(args, torch, dev) -> list[dict]:
    from smafa_tpu_torch.ops import compact as C, distance as D, keys as K
    from smafa_tpu_torch.ops import kstats as KS, min2 as M, min_count as MC

    out = []
    for kernel, L, b, rows, reps in SHAPES:
        if L not in args.only or kernel not in args.kernels:
            continue
        emb, zc, q_emb, shift, ts = operands(torch, D, K, L, b, rows,
                                             args.seed, dev)
        if kernel == "min2":
            fn = lambda: M.min2(q_emb, emb, zc, L, shift, True)  # noqa: E731
            ref = lambda: D.min2_reference(q_emb, emb, zc, L, shift, True)  # noqa: E731
        elif kernel == "kstats":
            fn = lambda: KS.kstats(q_emb, emb, zc, ts, rows, L)  # noqa: E731
            ref = lambda: D.stats_reference(q_emb, emb, zc, ts, rows, L)  # noqa: E731
        elif kernel == "compact_mask":
            th, _ = D.kmode_phase1(
                lambda t: KS.kstats(q_emb, emb, zc, t, rows, L), 99, L + 1,
                rows, L, b, dev)
            fn = lambda: (C.compact_mask(q_emb, emb, zc, th, L),)  # noqa: E731
            ref = lambda: (D.compact_mask_reference(q_emb, emb, zc, th, L),)  # noqa: E731
        else:
            fn = lambda: MC.min_count(q_emb, emb, zc, rows, L, shift, False)  # noqa: E731
            ref = lambda: D.min_count_reference(q_emb, emb, zc, rows, L, shift, False)  # noqa: E731
        want = ref()
        got = fn()
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = events_ms(torch, fn, reps)
        route, splits = plan(M, C, b, rows, q_emb.shape[1], dev, kernel)
        line = {"kernel": kernel, "L": L, "B": b, "rows": rows, "ms": ms,
                "bound_ms": bound_ms(b, rows, L), "route": route,
                "splits": splits, "exact": exact, "reps": reps}
        line["bound_share"] = line["bound_ms"] / ms
        print(json.dumps(line), flush=True)
        out.append(line)
        del emb, zc, q_emb, ts, want, got
        torch.cuda.empty_cache()
    return out


def ptxas_lines(text: str, match: str) -> list[str]:
    """The entry, register and spill lines of the kernels whose mangled
    name holds ``match``, and every C75xx line."""
    out, take = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            take = match in line
        if "C75" in line or (take and ("entry function" in line
                                       or "Used" in line or "spill" in line)):
            out.append(line.strip())
    return out


ENTRIES = {"min2": "smafa_min2", "compact": "smafa_compact_mask",
           "kstats": "smafa_kstats", "min_count": "smafa_min_count"}


def build(tmp: pathlib.Path, builds: dict, sources: tuple,
          csrc: dict | None = None) -> dict:
    """{build: ({source: its C entry}, ptxas lines)}: ``sources``
    (<csrc>/<source>.cu; this checkout's csrc, or ``csrc[build]``) in one
    library a build, each source compiled by an nvcc of its own with the
    build's flags, all started together, then linked."""
    from smafa_tpu_torch.ops import _build

    procs = {}
    for name, flags in builds.items():
        root = (csrc or {}).get(name, _build.CSRC)
        for src in sources:
            procs[name, src] = subprocess.Popen(
                [_build._nvcc(), *_build.COMPILE_FLAGS, *flags, "-c",
                 f"-I{root}", "-o", str(tmp / f"{name}_{src}.o"),
                 str(root / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for (name, src), proc in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name} {src}.cu did not build:\n{text}")
        logs[name] = logs.get(name, "") + text
    out = {}
    for name in builds:
        subprocess.run([_build._nvcc(), *_build.LINK_FLAGS, "-o",
                        str(tmp / f"lib{name}.so"),
                        *(str(tmp / f"{name}_{src}.o") for src in sources)],
                       check=True, timeout=300)
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        fns = {}
        for src in sources:
            fn = getattr(lib, ENTRIES[src])
            fn.argtypes = _build._SIGNATURES[ENTRIES[src]]
            fn.restype = ctypes.c_int
            fns[src] = fn
        out[name] = fns, ptxas_lines(logs[name], "wgchunk_kernel")
    return out


def entry_call(torch, D, KS, kernel, q_emb, emb, zc, ts, rows, L, shift, b,
               dev):
    """(want, res, args_of(splits)) of ``kernel``'s C entry at
    one shape: the plain version's outputs, result tensors and the
    entry's arguments (min2 with the count, min_count without it as the
    cluster calls it, kstats at the first cutoff pass's probes,
    compact_mask at the reads' K = 99 cutoffs)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    wp, ep = emb.shape[0], q_emb.shape[1]
    ptrs = (q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr())
    if kernel == "min2":
        want = D.min2_reference(q_emb, emb, zc, L, shift, True)
        res = [torch.empty_like(w) for w in want]
        part = torch.empty((3, 132, b), dtype=torch.int32, device=dev)
        return want, res, lambda s: (*ptrs, *(r.data_ptr() for r in res),
                                     part.data_ptr(), b, wp, ep, L, shift, 1,
                                     s, stream)
    if kernel == "compact_mask":
        th, _ = D.kmode_phase1(
            lambda t: KS.kstats(q_emb, emb, zc, t, rows, L), 99, L + 1, rows,
            L, b, dev)
        th = th.contiguous()
        want = (D.compact_mask_reference(q_emb, emb, zc, th, L),)
        res = [torch.empty_like(w) for w in want]
        return want, res, lambda s: (*ptrs, th.data_ptr(), res[0].data_ptr(),
                                     b, wp, ep, L, s, stream)
    if kernel == "kstats":
        want = D.stats_reference(q_emb, emb, zc, ts, rows, L)
        res = [torch.empty_like(w) for w in want]
        part = torch.empty((5, 132, b), dtype=torch.int32, device=dev)
        return want, res, lambda s: (*ptrs, ts.data_ptr(),
                                     *(r.data_ptr() for r in res),
                                     part.data_ptr(), b, rows, ep, L, s,
                                     stream)
    want = D.min_count_reference(q_emb, emb, zc, rows, L, shift, False)
    res = [torch.empty_like(w) for w in want]
    part = torch.empty((1, 132, b), dtype=torch.int32, device=dev)
    return want, res, lambda s: (*ptrs, res[0].data_ptr(), None,
                                 part.data_ptr(), b, rows, ep, L, shift, 0,
                                 s, stream)


def timed_call(torch, fn, args, res, want, reps, exact, key, label):
    """Time fn(*args) over reps calls; first, where ``key`` is given,
    hold its outputs exactly to ``want`` (recorded in exact[key])."""
    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{label}: cudaError {rc}")

    if key is not None:
        for r in res:
            r.fill_(-7)
        call()
        torch.cuda.synchronize()
        exact[key] = exact.get(key, True) and all(
            torch.equal(r, w) for r, w in zip(res, want))
    return events_ms(torch, call, reps)


def run_orders(args, torch, dev) -> list[dict]:
    """kstats and min_count in form (b) with each item order forced (see
    the module's text)."""
    from smafa_tpu_torch.ops import compact as C, distance as D, keys as K
    from smafa_tpu_torch.ops import kstats as KS, min2 as M

    from smafa_tpu_torch.ops import _build

    out = []
    with tempfile.TemporaryDirectory(prefix="long_route_probe_") as tmp:
        csrc = {}
        for name, rule in ORDER_BUILDS.items():
            csrc[name] = pathlib.Path(tmp) / name
            shutil.copytree(_build.CSRC, csrc[name])
            header = csrc[name] / "wg_long.cuh"
            text = header.read_text()
            if text.count(ORDER_RULE) != 1:
                raise SystemExit(f"{header}: the order rule is not found once")
            header.write_text(text.replace(ORDER_RULE, rule))
        libs = build(pathlib.Path(tmp), {n: [] for n in ORDER_BUILDS},
                     ORDER_SOURCES, csrc)
        print(json.dumps({"ptxas": {n: p for n, (_, p) in libs.items()}}),
              flush=True)
        for kernel, L, b in ORDER_SHAPES:
            rows, reps = next(x[3:] for x in SHAPES
                              if x[:3] == (kernel, L, b))
            emb, zc, q_emb, shift, ts = operands(torch, D, K, L, b, rows,
                                                 args.seed, dev)
            route, s = plan(M, C, b, rows, q_emb.shape[1], dev, kernel)
            want, res, args_of = entry_call(torch, D, KS, kernel,
                                            q_emb, emb, zc, ts, rows, L,
                                            shift, b, dev)
            times, exact = {}, {}
            for name in list(ORDER_BUILDS) + list(ORDER_BUILDS)[::-1]:
                fn = libs[name][0][kernel]
                times.setdefault(name, []).append(timed_call(
                    torch, fn, args_of(s), res, want, reps, exact, name,
                    f"{kernel} {name}"))
            line = {"kernel": kernel, "L": L, "B": b, "rows": rows,
                    "route": route, "splits": s, "ms": times,
                    "exact": exact, "rule_split_fastest": split_fastest(
                        b, s, q_emb.shape[1], M.sm_count(dev)),
                    "bound_ms": bound_ms(b, rows, L), "reps": reps}
            print(json.dumps(line), flush=True)
            out.append(line)
            del emb, zc, q_emb, ts, want, res
            torch.cuda.empty_cache()
    return out


def run_probes(args, torch, dev) -> list[dict]:
    """Every probe build at each shape (see the module's text)."""
    from smafa_tpu_torch.ops import compact as C, distance as D, keys as K
    from smafa_tpu_torch.ops import kstats as KS, min2 as M

    out = []
    with tempfile.TemporaryDirectory(prefix="long_route_probe_") as tmp:
        libs = build(pathlib.Path(tmp), PROBE_BUILDS, PROBE_SOURCES)
        print(json.dumps({"ptxas": {n: p for n, (_, p) in libs.items()}}),
              flush=True)
        order = list(PROBE_BUILDS) + list(PROBE_BUILDS)[::-1]
        for kernel, L, b, rows, reps in SHAPES:
            if L not in args.only or kernel not in args.kernels:
                continue
            emb, zc, q_emb, shift, ts = operands(torch, D, K, L, b, rows,
                                                 args.seed, dev)
            wp, ep = emb.shape[0], q_emb.shape[1]
            route, plan_s = plan(M, C, b, rows, ep, dev, kernel)
            sweep = sorted({plan_s, *(x for x in SPLIT_SWEEP
                                      if x <= wp // D.WP_MULTIPLE)})
            want, res, args_of = entry_call(torch, D, KS, kernel,
                                            q_emb, emb, zc, ts, rows, L,
                                            shift, b, dev)
            src = "compact" if kernel == "compact_mask" else kernel
            times, exact = {}, {}

            def timed(name, s):
                key = f"{name}@{s}" if name in EXACT_BUILDS else None
                return timed_call(torch, libs[name][0][src], args_of(s), res,
                                  want, reps, exact, key, f"{kernel} {name}")

            for name in order:
                times.setdefault(name, []).append(timed(name, plan_s))
            if args.splits:
                for s in sweep:
                    for name in EXACT_BUILDS + EXACT_BUILDS[::-1]:
                        times.setdefault(f"{name}@{s}", []).append(
                            timed(name, s))
            line = {"kernel": kernel, "L": L, "B": b, "rows": rows,
                    "route": route, "splits": plan_s, "ms": times,
                    "exact": exact, "bound_ms": bound_ms(b, rows, L),
                    "share": {k: bound_ms(b, rows, L) / min(v)
                              for k, v in times.items()}, "reps": reps}
            print(json.dumps(line), flush=True)
            out.append(line)
            del emb, zc, q_emb, ts, want, res
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=_HERE)
    ap.add_argument("--orders", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--only", type=int, nargs="+", default=[150, 300, 29903])
    ap.add_argument("--kernels", nargs="+",
                    default=["min2", "kstats", "compact_mask", "min_count"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name()
    run = (run_orders if args.orders else run_probes if args.probes
           else run_wrappers)
    lines = run(args, torch, dev)
    print(json.dumps({"root": str(args.root), "orders": args.orders,
                      "probes": args.probes, "nvidia_smi": card}), flush=True)
    bad = [x for x in lines if not (all(x["exact"].values())
                                    if isinstance(x["exact"], dict)
                                    else x["exact"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
