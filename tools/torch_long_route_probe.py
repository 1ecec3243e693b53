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

``--forms`` (kstats, the split tile's K-chunked route): builds this
checkout's csrc/kstats.cu as it is and a copy patched to run form (b)
of the K-chunked split tile (query and db chunks streamed) at every EP
(one nvcc each, all started together), then times form (a) (query rows
resident) against form (b) through their C entries, at the wrapper's db
splits, at each shape with EP <= 672, in turns (a, b, b, a). Prints
each build's ptxas lines of the chunk kernels.

``--probes`` (min2 and compact_mask, the K-chunked wgmma tile of
csrc/wg_long.cuh): builds this checkout's csrc/min2.cu and compact.cu
into one library as they are ("kernel") and as probe builds by ``-D``
macros (``copies_only``: the copies and the ring, no product, no
epilogue; ``products_only``: the products on whatever shared memory
holds, no copy, no epilogue; ``no_epilogue``: copies and products),
one nvcc a build, all started together; then at each min2 and
compact_mask shape times every build's C entry at the wrapper's db
splits in turns (the builds in order, then reversed), the kernel held
exactly to the plain version first. ``--splits`` also times the kernel
at 1, 8, 16, 33, 66 and 132 db splits (where the db has that many
64-row tiles). Prints each build's ptxas lines of the long-route
kernels (any C75xx line included).

    python3 tools/torch_long_route_probe.py [--root DIR] [--forms]
        [--probes [--splits]] [--only 150 300 29903] [--seed N]

Needs a CUDA device (and nvcc); run from anywhere. Prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import pathlib
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
# the text of each source that picks form (a), and form (b) forced
FORM_B = ("EP <= RESIDENT_EP_MAX", "false")
FORM_SOURCES = ("kstats",)
# the probe builds of min2.cu and compact.cu: name -> -D flags
PROBE_BUILDS = {"kernel": [], "copies_only": ["-DWG_LONG_PROBE_COPIES_ONLY"],
                "products_only": ["-DWG_LONG_PROBE_PRODUCTS_ONLY"],
                "no_epilogue": ["-DWG_LONG_PROBE_NO_EPILOGUE"]}
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
    ``live_plan``, min2's and compact_mask's ``kernel_plan``. In a tree
    without ``kernel_plan`` min2 and compact_mask took ``launch_plan``,
    and in one whose plan takes ``chunked`` (before compact_mask and
    min_count had a K-chunked route) min2 and kstats pass it."""
    if kernel in ("min2", "compact_mask"):
        mod = C if kernel == "compact_mask" else M
        if hasattr(mod, "kernel_plan"):
            return mod.kernel_plan(b, rows, ep, M.sm_count(dev))
    fn = M.live_plan if kernel in ("kstats", "min_count") else M.launch_plan
    kw = ({"chunked": True} if kernel in ("min2", "kstats")
          and "chunked" in inspect.signature(fn).parameters else {})
    return fn(b, rows, ep, M.sm_count(dev), **kw)


def run_wrappers(args, torch, dev) -> list[dict]:
    from smafa_tpu_torch.ops import compact as C, distance as D, keys as K
    from smafa_tpu_torch.ops import kstats as KS, min2 as M, min_count as MC

    out = []
    for kernel, L, b, rows, reps in SHAPES:
        if L not in args.only:
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


def build_forms(tmp: pathlib.Path) -> dict[str, tuple[ctypes.CDLL, list[str]]]:
    """(library, ptxas lines) of each source as it is ("a") and with form
    (b) forced ("b"), one nvcc each, all started together."""
    from smafa_tpu_torch.ops import _build

    procs = {}
    for src in FORM_SOURCES:
        text = (_build.CSRC / f"{src}.cu").read_text()
        if text.count(FORM_B[0]) != 1:
            raise SystemExit(f"{src}.cu: {FORM_B[0]!r} is not found once")
        for form, body in (("a", text), ("b", text.replace(*FORM_B))):
            name = f"{src}_{form}"
            (tmp / f"{name}.cu").write_text(body)
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
                 f"-I{_build.CSRC}", "-o", str(tmp / f"lib{name}.so"),
                 str(tmp / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name} did not build:\n{text}")
        ptxas, take = [], False
        for line in text.splitlines():
            if "Compiling entry function" in line:
                take = "chunk_kernel" in line
            if take and ("entry function" in line or "Used" in line
                         or "spill" in line or "stack" in line):
                ptxas.append(line.strip())
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        fn = getattr(lib, f"smafa_{name.split('_')[0]}")
        fn.argtypes = _build._SIGNATURES[fn.__name__]
        fn.restype = ctypes.c_int
        out[name] = fn, ptxas
    return out


def run_forms(args, torch, dev) -> list[dict]:
    from smafa_tpu_torch.ops import distance as D, keys as K
    from smafa_tpu_torch.ops import min2 as M

    out = []
    with tempfile.TemporaryDirectory(prefix="long_route_probe_") as tmp:
        libs = build_forms(pathlib.Path(tmp))
        print(json.dumps({"ptxas": {n: p for n, (_, p) in libs.items()}}),
              flush=True)
        for kernel, L, b, rows, reps in SHAPES:
            ep = D.embed_width(L)
            if (L not in args.only or ep > M.RESIDENT_EP_MAX
                    or kernel not in FORM_SOURCES):
                continue
            emb, zc, q_emb, _, ts = operands(torch, D, K, L, b, rows,
                                             args.seed, dev)
            route, s = plan(M, None, b, rows, ep, dev, kernel)
            stream = torch.cuda.current_stream(dev).cuda_stream
            want = D.stats_reference(q_emb, emb, zc, ts, rows, L)
            res = [torch.empty_like(w) for w in want]
            part = torch.empty((K.KSTATS_PROBES + 1, s, b),
                               dtype=torch.int32, device=dev)
            args_of = lambda: (q_emb.data_ptr(), emb.data_ptr(),  # noqa: E731
                               zc.data_ptr(), ts.data_ptr(),
                               *(r.data_ptr() for r in res),
                               part.data_ptr(), b, rows, ep, L, s, stream)
            times, exact = {"a": [], "b": []}, {}
            for form in ("a", "b", "b", "a"):
                fn = libs[f"{kernel}_{form}"][0]

                def call():
                    rc = fn(*args_of())
                    if rc:
                        raise RuntimeError(f"{kernel} form {form}: cudaError {rc}")

                for r in res:
                    r.fill_(-7)
                call()
                torch.cuda.synchronize()
                exact[form] = exact.get(form, True) and all(
                    torch.equal(r, w) for r, w in zip(res, want))
                times[form].append(events_ms(torch, call, reps))
            line = {"kernel": kernel, "L": L, "B": b, "rows": rows,
                    "splits": s, "route": route, "ms": times, "exact": exact,
                    "bound_ms": bound_ms(b, rows, L), "reps": reps}
            print(json.dumps(line), flush=True)
            out.append(line)
            del emb, zc, q_emb, ts, want, res, part
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


def build_probes(tmp: pathlib.Path) -> dict[str, tuple]:
    """{build: ((min2 entry, compact_mask entry), ptxas lines)}: this
    checkout's min2.cu and compact.cu in one library a build."""
    from smafa_tpu_torch.ops import _build

    procs = {}
    for name, flags in PROBE_BUILDS.items():
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
             *flags, f"-I{_build.CSRC}", "-o", str(tmp / f"lib{name}.so"),
             str(_build.CSRC / "min2.cu"), str(_build.CSRC / "compact.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name} did not build:\n{text}")
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        fns = []
        for entry in ("smafa_min2", "smafa_compact_mask"):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns.append(fn)
        out[name] = tuple(fns), ptxas_lines(text, "wgchunk_kernel")
    return out


def run_probes(args, torch, dev) -> list[dict]:
    """Every probe build at each min2 and compact_mask shape (see the
    module's text)."""
    from smafa_tpu_torch.ops import compact as C, distance as D, keys as K
    from smafa_tpu_torch.ops import kstats as KS, min2 as M

    out = []
    with tempfile.TemporaryDirectory(prefix="long_route_probe_") as tmp:
        libs = build_probes(pathlib.Path(tmp))
        print(json.dumps({"ptxas": {n: p for n, (_, p) in libs.items()}}),
              flush=True)
        order = list(PROBE_BUILDS) + list(PROBE_BUILDS)[::-1]
        for kernel, L, b, rows, reps in SHAPES:
            if L not in args.only or kernel not in ("min2", "compact_mask"):
                continue
            emb, zc, q_emb, shift, _ = operands(torch, D, K, L, b, rows,
                                                args.seed, dev)
            wp, ep = emb.shape[0], q_emb.shape[1]
            route, plan_s = plan(M, C, b, rows, ep, dev, kernel)
            stream = torch.cuda.current_stream(dev).cuda_stream
            sweep = sorted({plan_s, *(x for x in SPLIT_SWEEP
                                      if x <= wp // D.WP_MULTIPLE)})
            if kernel == "min2":
                want = D.min2_reference(q_emb, emb, zc, L, shift, True)
                res = [torch.empty_like(w) for w in want]
                part = torch.empty((3, max(sweep), b), dtype=torch.int32,
                                   device=dev)
                idx = 0

                def args_of(s):
                    return (q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(),
                            *(r.data_ptr() for r in res), part.data_ptr(), b,
                            wp, ep, L, shift, 1, s, stream)
            else:
                th, _ = D.kmode_phase1(
                    lambda t: KS.kstats(q_emb, emb, zc, t, rows, L), 99,
                    L + 1, rows, L, b, dev)
                th = th.contiguous()
                want = (D.compact_mask_reference(q_emb, emb, zc, th, L),)
                res = [torch.empty_like(w) for w in want]
                idx = 1

                def args_of(s):
                    return (q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(),
                            th.data_ptr(), res[0].data_ptr(), b, wp, ep, L,
                            s, stream)
            times, exact = {}, {}

            def timed(name, s):
                fn = libs[name][0][idx]

                def call():
                    rc = fn(*args_of(s))
                    if rc:
                        raise RuntimeError(f"{kernel} {name}: cudaError {rc}")

                if name in EXACT_BUILDS:
                    for r in res:
                        r.fill_(-7)
                    call()
                    torch.cuda.synchronize()
                    key = f"{name}@{s}"
                    exact[key] = exact.get(key, True) and all(
                        torch.equal(r, w) for r, w in zip(res, want))
                return events_ms(torch, call, reps)

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
            del emb, zc, q_emb, want, res
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=_HERE)
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--only", type=int, nargs="+", default=[150, 300, 29903])
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
    run = (run_forms if args.forms else run_probes if args.probes
           else run_wrappers)
    lines = run(args, torch, dev)
    print(json.dumps({"root": str(args.root), "forms": args.forms,
                      "probes": args.probes, "nvidia_smi": card}), flush=True)
    bad = [x for x in lines if not (all(x["exact"].values())
                                    if isinstance(x["exact"], dict)
                                    else x["exact"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
