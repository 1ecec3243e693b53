"""What sets the pace of the short route (the wgmma tile of
csrc/wg_scan.cuh, L <= 64) of min2, compact_mask, kstats and min_count
on a card: the kernels as they are, probe builds of the same sources,
and other checkouts, timed in turns.

Each ``--root`` (a checkout; this one unless given, and given more than
once for a change against its parent in one call) has its
``smafa_tpu_torch/csrc/min2.cu``, ``compact.cu``, ``kstats.cu`` and
``min_count.cu`` built into one library with the plain C entries
``smafa_min2``, ``smafa_compact_mask``, ``smafa_kstats`` and
``smafa_min_count`` (one nvcc a source, all started together, then one
link, with the root's own ``ops/_build.py`` flags); each root launches
at its own plans' db splits (``kernel_plan`` of min2 and compact_mask,
``live_plan`` of kstats and min_count). ``--probes`` also builds this
checkout's sources edited in text, at its plans (the probe builds give
wrong results by design and are timed only; ``--probes NAME ...``
builds only those named):

- ``product_only``: min2's epilogue cut to one add of an accumulator a
  tile, which keeps every product;
- ``fold_only``: min2's max-first fold kept, its exact update (keys and
  counts at the running best) cut;
- ``no_store``: compact_mask's mask stores never taken (the epilogue
  kept);
- ``no_overlap``: both of a warpgroup's products retired before either
  epilogue runs (the overlap only across the two warpgroups);
- ``stores_in_flight``: compact_mask storing after each tile, so tile
  0's stores run beside tile 1's product in flight (ptxas's C7514, if
  it serialises the wgmma, is printed; the mask is wrong by design);
- ``no_epilogue``: the copies and the products as they are, every
  epilogue replaced by a compare of one accumulator (which keeps the
  products);
- ``copies_only``: the copies and the ring's waits alone, no product
  and no epilogue;
- ``products_only``: the products on whatever shared memory holds, no
  copy (the producer only arrives) and no epilogue;
- ``pairs``: kstats counting in 16-bit pairs (a compare and a
  predicated add a probe) below 64 bp too, where it counts in byte
  lanes.

Every build that is the kernel is held exactly to the plain versions
(``min2_reference``, ``compact_mask_reference``, ``stats_reference``,
``min_count_reference``) on small shapes first.

Shapes (L = 60, 2^20 db rows: random codes 0-3 with 20% of the rows in
duplicate groups of 2, 5 and 40, as chip_smoke.py's db; reads are db
rows with ~5% substitutions): min2 at 32768, 4096 and 512 reads, and at
4096 reads against a db a tenth of whose rows copy one row ("heavy":
the exact update on many steps); compact_mask at 4096, 8192 and 512
reads at thresholds 0-6; kstats at 16384 and 4096 reads x 2^20 + 37
live rows, thresholds 0-60 (one K-mode cutoff pass); min_count at
32768 x 32768, 8192 x 16384 and 2048 x 4096 rows, without the count
(the cluster's shapes). ``--splits`` also times this checkout (or the
first root) at other db splits. Timed by CUDA events over back-to-back
calls, in the order of the builds and then in reverse (parent, change,
change, parent for two roots). ``--sass`` counts each build's warpgroup
MMA (``IGMMA``) and TMA load (``UTMALDG``) lines (``cuobjdump -sass``).

    python3 tools/torch_wg_probe.py [--root DIR ...] [--probes [NAME ...]]
        [--splits] [--sass] [--seed N]

Needs a CUDA device and nvcc; run from anywhere. Prints one JSON line a
build and one of times, with the card's name and power limit; exits 1
if a build that is the kernel differs from the plain versions.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_HERE))

PEAK_INT8_OPS = 1.979e15  # H100 SXM dense int8 tensor-core peak, op/s
L, ROWS = 60, 1 << 20
KSTATS_ROWS = ROWS + 37
SOURCES = ("min2.cu", "compact.cu", "kstats.cu", "min_count.cu")
ENTRIES = ("smafa_min2", "smafa_compact_mask", "smafa_kstats",
           "smafa_min_count")
MIN2_EXACT = "    if ((tb[0] >= best[2 * M]) | (tb[1] >= best[2 * M + 1])) {"
MIN2_FOLD = "    int tb[2] = {INT_MIN, INT_MIN};\n"
TILE0 = "      epi.template tile<0>(acc0, z, s);\n"
TILE1 = "      epi.template tile<1>(acc1, z, s);\n"
# every epilogue replaced by a compare that keeps the products
NO_EPILOGUE = [(TILE0, "      if (acc0[0] == 0x7fffffff) epi.end(im);\n"),
               (TILE1, "      if (acc1[0] == 0x7fffffff) epi.end(im);\n")]
STEP_BODY = """      wgmma_wait<1>();  // tile 0 done; tile 1's product runs on
      fence_regs(acc0);
      zload(J);
      fence_proxy_async();  // the zc read before TMA may refill the stage
      epi.template tile<0>(acc0, z, s);
      wgmma_wait<0>();
      fence_regs(acc1);
      warp_arrive(rg.empty + J % RING, lane);
      epi.template tile<1>(acc1, z, s);
"""
COPIES = """      mbar_expect_tx(bar, NKP * N * PANEL + N * 4);
#pragma unroll
      for (int p = 0; p < NKP; ++p) {
        tma_load_2d(rg.panels + (st * NKP + p) * N * PANEL, tdb, p * PANEL,
                    s * N, bar);
      }
      tma_load_1d(rg.zc + st * N, tzc, s * N, bar);
"""
PRODUCTS = "      issue(acc0, af[0], J);\n      issue(acc1, af[1], J);\n"
# name: {source: [(text, replacement), ...]} on this checkout's csrc
PROBES = {
    "product_only": {"min2.cu": [(MIN2_FOLD, "    cnt[2 * M] += acc[0];\n"
                                  "    return;\n" + MIN2_FOLD)]},
    "fold_only": {"min2.cu": [(MIN2_EXACT, "    cnt[2 * M] += tb[0];\n"
                               "    cnt[2 * M + 1] += tb[1];\n"
                               "    if (false) {")]},
    "no_store": {"compact.cu": [("if (M == 1 && out != nullptr) {",
                                 "if (M == 1 && out != nullptr && seq_len < 0) {")]},
    "no_overlap": {"wg_scan.cuh": [(STEP_BODY, """      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      zload(J);
      fence_proxy_async();
      warp_arrive(rg.empty + J % RING, lane);
      epi.template tile<0>(acc0, z, s);
      epi.template tile<1>(acc1, z, s);
""")]},
    "stores_in_flight": {"compact.cu": [("    if (M == 1 && out != nullptr) {",
                                         "    if (out != nullptr) {")]},
    "no_epilogue": {"wg_scan.cuh": NO_EPILOGUE},
    "copies_only": {"wg_scan.cuh": [(PRODUCTS, ""), (TILE0, ""), (TILE1, "")]},
    "products_only": {"wg_scan.cuh": [(COPIES, "      mbar_arrive(bar);\n"),
                                      *NO_EPILOGUE]},
    "pairs": {"kstats.cu": [("const bool bytes = seq_len < 64;",
                             "const bool bytes = false;")]},
}


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def load_module(path: pathlib.Path, name: str):
    """A root's module by file, run against this checkout's package."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def checkout(root: pathlib.Path, tag: str) -> tuple:
    """(csrc directory, the root's _build module, its min2 module, whose
    plans the root's wrappers follow, its compact_mask plan)."""
    rb = load_module(root / "smafa_tpu_torch/ops/_build.py", f"_build_{tag}")
    m2 = load_module(root / "smafa_tpu_torch/ops/min2.py", f"_min2_{tag}")
    cm = load_module(root / "smafa_tpu_torch/ops/compact.py", f"_compact_{tag}")
    return root / "smafa_tpu_torch/csrc", rb, (m2, cm.kernel_plan)


def sources(roots, probes, tmp: pathlib.Path) -> dict:
    """{build name: (csrc directory, _build module, plans)}: each root as
    it is, then the probe builds named (all with an empty list), edits of
    this checkout's sources."""
    out = {f"root{i}": checkout(root, f"root{i}") for i, root in enumerate(roots)}
    if probes is not None:
        base = checkout(_HERE, "here")
        for name in probes or PROBES:
            d = tmp / name
            shutil.copytree(base[0], d)
            for src, reps in PROBES[name].items():
                text = (d / src).read_text()
                for a, b in reps:
                    if text.count(a) != 1:
                        raise SystemExit(f"probe {name}: {src} lacks its text")
                    text = text.replace(a, b)
                (d / src).write_text(text)
            out[name] = (d, base[1], base[2])
    return out


def build_all(builds: dict, tmp: pathlib.Path) -> dict:
    """{name: (library, ptxas lines, path, plans)}: every source of every
    build compiled at once (as many at a time as the host has cores),
    then each build linked."""
    from smafa_tpu_torch.ops import _build

    def compile_one(job):
        name, csrc, rb, src = job
        obj = tmp / f"{name}_{src}.o"
        proc = subprocess.run(
            [_build._nvcc(), *rb.COMPILE_FLAGS, f"-I{csrc}", "-c", "-o",
             str(obj), str(csrc / src)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"build {name} failed on {src}:\n{proc.stdout}"
                             f"{proc.stderr}")
        return obj, proc.stdout + proc.stderr

    jobs = [(name, csrc, rb, src) for name, (csrc, rb, _) in builds.items()
            for src in SOURCES]
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        done = dict(zip([(j[0], j[3]) for j in jobs], pool.map(compile_one, jobs)))
    out = {}
    for name, (_, rb, plans) in builds.items():
        lib = tmp / f"libwg_{name}.so"
        subprocess.run([_build._nvcc(), *rb.LINK_FLAGS, "-o", str(lib),
                        *(str(done[(name, src)][0]) for src in SOURCES)],
                       check=True, capture_output=True, timeout=300)
        ptxas, entry = [], None
        for src in SOURCES:
            for line in done[(name, src)][1].splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    entry = m.group(1)
                if "C75" in line or (entry and "_wg_kernel" in entry and (
                        "Used" in line or "spill" in line)):
                    ptxas.append(line.strip())
        dll = ctypes.CDLL(str(lib))
        for fn in ENTRIES:
            getattr(dll, fn).argtypes = _build._SIGNATURES[fn]
            getattr(dll, fn).restype = ctypes.c_int
        out[name] = (dll, ptxas, lib, plans)
    return out


def sass_counts(lib: pathlib.Path) -> dict:
    from smafa_tpu_torch.ops import _build

    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {"sass": "not measured (no cuobjdump)"}
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    res, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            res[name] = {"IGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in res[name]:
                res[name][op] += op in line.split(";")[0]
    return {n: c for n, c in res.items() if "_wg_kernel" in n}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, action="append")
    ap.add_argument("--probes", nargs="*", choices=sorted(PROBES))
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    from smafa_tpu_torch.ops import distance as D, keys as K

    roots = [r.resolve() for r in (args.root or [_HERE])]
    card = card_name()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="wg_probe_") as tmp:
        libs = build_all(sources(roots, args.probes, pathlib.Path(tmp)),
                         pathlib.Path(tmp))
        for name, (_, ptxas, lib, _) in libs.items():
            line = {"build": name, "ptxas": ptxas}
            if args.sass:
                line["sass"] = sass_counts(lib)
            print(json.dumps(line), flush=True)

        def random_db(n, heavy=False):
            codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
            perm, used = rng.permutation(n), 0
            for g in (2, 5, 40):
                k = (n // 5 // 3) // g
                pos = perm[used:used + k * g].reshape(k, g)
                used += k * g
                codes[pos[:, 1:]] = codes[pos[:, :1]]
            if heavy:
                codes[rng.integers(0, n, n // 10)] = codes[3]
            return codes

        def operands(n, b, heavy=False):
            codes = random_db(n, heavy)
            q = codes[rng.integers(0, n, b)].copy()
            mut = rng.random(q.shape) < 0.05
            q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
            wp = -(-n // 64) * 64
            emb, zc = D.embed_db(torch.from_numpy(codes).to(dev), L, wp)
            q_emb = D.expand_embed_query(torch.from_numpy(q).to(dev), L)
            return emb, zc, q_emb, K.packing_shift(L, wp)

        stream = torch.cuda.current_stream(dev).cuda_stream

        def part(s, b):
            return torch.empty((K.KSTATS_PROBES + 1, s, b), dtype=torch.int32,
                               device=dev)

        def min2(name, q_emb, emb, zc, shift, s=None):
            dll, _, _, (m2, _) = libs[name]
            b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
            s = s or m2.kernel_plan(b, wp, ep, sms)[1]
            out = torch.empty((3, b), dtype=torch.int32, device=dev)
            rc = dll.smafa_min2(q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(),
                                out[0].data_ptr(), out[1].data_ptr(),
                                out[2].data_ptr(), part(s, b).data_ptr(), b,
                                wp, ep, L, shift, 1, s, stream)
            if rc:
                raise SystemExit(f"{name}: min2 launch failed: cudaError {rc}")
            return out

        def compact(name, q_emb, emb, zc, th, s=None):
            dll, _, _, (_, plan) = libs[name]
            b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
            s = s or plan(b, wp, ep, sms)[1]
            mask = torch.empty((b, wp // 32), dtype=torch.int32, device=dev)
            rc = dll.smafa_compact_mask(q_emb.data_ptr(), emb.data_ptr(),
                                        zc.data_ptr(), th.data_ptr(),
                                        mask.data_ptr(), b, wp, ep, L, s, stream)
            if rc:
                raise SystemExit(f"{name}: compact launch failed: cudaError {rc}")
            return mask

        def kstats(name, q_emb, emb, zc, ts, n_valid, s=None):
            dll, _, _, (m2, _) = libs[name]
            b, ep = q_emb.shape
            s = s or m2.live_plan(b, n_valid, ep, sms, m2.KSTATS_ITEM_STEPS)[1]
            cnt = torch.empty((K.KSTATS_PROBES, b), dtype=torch.int32, device=dev)
            mx = torch.empty((b,), dtype=torch.int32, device=dev)
            rc = dll.smafa_kstats(q_emb.data_ptr(), emb.data_ptr(),
                                  zc.data_ptr(), ts.data_ptr(), cnt.data_ptr(),
                                  mx.data_ptr(), part(s, b).data_ptr(), b,
                                  n_valid, ep, L, s, stream)
            if rc:
                raise SystemExit(f"{name}: kstats launch failed: cudaError {rc}")
            return cnt, mx

        def min_count(name, q_emb, emb, zc, n_valid, shift, s=None):
            dll, _, _, (m2, _) = libs[name]
            b, ep = q_emb.shape
            s = s or m2.live_plan(b, n_valid, ep, sms,
                                  m2.MIN_COUNT_ITEM_STEPS)[1]
            key = torch.empty((b,), dtype=torch.int32, device=dev)
            rc = dll.smafa_min_count(q_emb.data_ptr(), emb.data_ptr(),
                                     zc.data_ptr(), key.data_ptr(), None,
                                     part(s, b).data_ptr(), b, n_valid, ep, L,
                                     shift, 0, s, stream)
            if rc:
                raise SystemExit(f"{name}: min_count launch failed: "
                                 f"cudaError {rc}")
            return key

        def thresholds(b):
            return torch.from_numpy(rng.integers(0, 7, b).astype(np.int32)).to(dev)

        def probes_ts(b):
            return torch.from_numpy(rng.integers(
                0, L + 1, (K.KSTATS_PROBES, b)).astype(np.int32)).to(dev)

        exact = {}
        kernels = [n for n in libs if n.startswith("root")]
        for n_rows, b, heavy in ((70001, 300, True), (5000, 77, False),
                                 (64, 1, False)):
            emb, zc, q_emb, shift = operands(n_rows, b, heavy)
            want = torch.stack(D.min2_reference(q_emb, emb, zc, L, shift, True))
            th, ts = thresholds(b), probes_ts(b)
            want_mask = D.compact_mask_reference(q_emb, emb, zc, th, L)
            n_valid = max(1, n_rows - 37)
            want_st = D.stats_reference(q_emb, emb, zc, ts, n_valid, L)
            want_key = D.min_count_reference(q_emb, emb, zc, n_valid, L, shift,
                                             False)[0]
            for name in kernels:
                ok = (torch.equal(min2(name, q_emb, emb, zc, shift), want)
                      and torch.equal(compact(name, q_emb, emb, zc, th),
                                      want_mask)
                      and all(torch.equal(g, w) for g, w in zip(
                          kstats(name, q_emb, emb, zc, ts, n_valid), want_st))
                      and torch.equal(min_count(name, q_emb, emb, zc, n_valid,
                                                shift), want_key))
                exact[name] = exact.get(name, True) and ok

        def time_ms(fn, reps):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / reps

        emb_h, zc_h, q_h, shift_h = operands(ROWS, 4096, True)
        emb, zc, q_emb, shift = operands(ROWS, 32768)
        emb_k, zc_k, q_k, _ = operands(KSTATS_ROWS, 16384)
        qs = {b: q_emb[:b].contiguous() for b in (512, 4096, 8192)}
        ths = {b: thresholds(b) for b in (512, 4096, 8192)}
        tss = {b: probes_ts(b) for b in (16384, 4096)}
        qks = {16384: q_k, 4096: q_k[:4096].contiguous()}
        mc = {b: operands(w, b) for b, w in ((32768, 32768), (8192, 16384),
                                             (2048, 4096))}
        # (case, (B, db rows)): every case's B x rows, for its bound
        cases = {"min2_32768": (lambda n: min2(n, q_emb, emb, zc, shift), 5),
                 "min2_4096": (lambda n: min2(n, qs[4096], emb, zc, shift), 20),
                 "min2_512": (lambda n: min2(n, qs[512], emb, zc, shift), 50),
                 "min2_heavy_4096": (lambda n: min2(n, q_h, emb_h, zc_h,
                                                    shift_h), 10)}
        shapes = {"min2_32768": (32768, ROWS), "min2_4096": (4096, ROWS),
                  "min2_512": (512, ROWS), "min2_heavy_4096": (4096, ROWS)}
        for b in (4096, 8192, 512):
            cases[f"compact_{b}"] = (
                lambda n, b=b: compact(n, qs[b], emb, zc, ths[b]),
                50 if b == 512 else 10)
            shapes[f"compact_{b}"] = (b, ROWS)
        for b in (16384, 4096):
            cases[f"kstats_{b}"] = (
                lambda n, b=b: kstats(n, qks[b], emb_k, zc_k, tss[b],
                                      KSTATS_ROWS), 10 if b == 16384 else 20)
            shapes[f"kstats_{b}"] = (b, KSTATS_ROWS)
        for b, (e, z, q, sh) in mc.items():
            w = e.shape[0]
            cases[f"min_count_{b}"] = (
                lambda n, e=e, z=z, q=q, sh=sh, w=w: min_count(n, q, e, z, w, sh),
                {32768: 20, 8192: 50, 2048: 100}[b])
            shapes[f"min_count_{b}"] = (b, w)
        times = {n: {c: [] for c in cases} for n in libs}
        for name in [*libs, *reversed(libs)]:
            for case, (fn, reps) in cases.items():
                times[name][case].append(time_ms(lambda: fn(name), reps))
        bound = {c: 2 * b * w * 4 * L / PEAK_INT8_OPS * 1e3
                 for c, (b, w) in shapes.items()}
        share = {n: {c: bound[c] / (sum(v) / len(v)) for c, v in t.items()}
                 for n, t in times.items()}
        sweep = {}
        here = next((f"root{i}" for i, r in enumerate(roots) if r == _HERE),
                    "root0")
        if args.splits:
            for b, ss in ((32768, (1, 2, 4, 33)), (4096, (4, 8, 16, 33)),
                          (512, (33, 66, 132))):
                q = q_emb if b == 32768 else qs[b]
                sweep[f"min2_{b}"] = {s: time_ms(lambda: min2(
                    here, q, emb, zc, shift, s), 5) for s in ss}
                if b < 32768:
                    sweep[f"compact_{b}"] = {s: time_ms(lambda: compact(
                        here, q, emb, zc, ths[b], s), 10) for s in ss}
            for b, ss in ((16384, (2, 4, 33, 66)), (4096, (8, 16, 33, 66))):
                sweep[f"kstats_{b}"] = {s: time_ms(lambda: kstats(
                    here, qks[b], emb_k, zc_k, tss[b], KSTATS_ROWS, s), 10)
                    for s in ss}
            for b, ss in ((32768, (1, 2)), (8192, (4, 8)), (2048, (8, 16, 33))):
                e, z, q, sh = mc[b]
                sweep[f"min_count_{b}"] = {s: time_ms(lambda: min_count(
                    here, q, e, z, e.shape[0], sh, s), 20) for s in ss}
        print(json.dumps({"nvidia_smi": card, "roots": [str(r) for r in roots],
                          "exact": exact, "bound_ms": bound, "ms": times,
                          "bound_share": share, "splits_ms": sweep}))
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
