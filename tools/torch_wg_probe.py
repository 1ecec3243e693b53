"""What sets the pace of min2's and compact_mask's short route (the wgmma
tile of csrc/wg_scan.cuh) on a card: the kernels as they are, probe
builds of the same sources, and other checkouts, timed in turns.

Each ``--root`` (a checkout; this one unless given, and given more than
once for a change against its parent in one call) has its
``smafa_tpu_torch/csrc/min2.cu`` and ``compact.cu`` built into one
library with the plain C entries ``smafa_min2`` and
``smafa_compact_mask`` (one nvcc a build, all started together, with the
root's own ``ops/_build.py`` flags); each root launches at its own plan's
db splits (``kernel_plan``, or ``launch_plan`` in a checkout without
it). ``--probes`` also builds this checkout's sources edited in text,
at its plan (the probe builds give wrong results by design and are
timed only):

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
  it serialises the wgmma, is printed; the mask is wrong by design).

Every build that is the kernel is held exactly to the plain versions
(``min2_reference``, ``compact_mask_reference``) on small shapes first.

Shapes (L = 60, 2^20 db rows: random codes 0-3 with 20% of the rows in
duplicate groups of 2, 5 and 40, as chip_smoke.py's db; reads are db
rows with ~5% substitutions): min2 at 32768, 4096 and 512 reads, and at
4096 reads against a db a tenth of whose rows copy one row ("heavy":
the exact update on many steps); compact_mask at 4096, 8192 and 512
reads at thresholds 0-6. ``--splits`` also times this checkout (or the
first root) at other db splits. Timed by CUDA events over back-to-back calls, in the order of
the builds and then in reverse (parent, change, change, parent for two
roots). ``--sass`` counts each build's warpgroup MMA (``IGMMA``) and TMA
load (``UTMALDG``) lines (``cuobjdump -sass``).

    python3 tools/torch_wg_probe.py [--root DIR ...] [--probes] [--splits]
        [--sass] [--seed N]

Needs a CUDA device and nvcc; run from anywhere. Prints one JSON line a
build and one of times, with the card's name and power limit; exits 1
if a build that is the kernel differs from the plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
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
MIN2_EXACT = "    if ((tb[0] >= best[2 * M]) | (tb[1] >= best[2 * M + 1])) {"
MIN2_FOLD = "    int tb[2] = {INT_MIN, INT_MIN};\n"
STEP_BODY = """      wgmma_wait<1>();  // tile 0 done; tile 1's product runs on
      fence_regs(acc0);
      zload(J);
      epi.template tile<0>(acc0, z, s);
      wgmma_wait<0>();
      fence_regs(acc1);
      warp_arrive(rg.empty + J % RING, lane);
      epi.template tile<1>(acc1, z, s);
"""
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
      warp_arrive(rg.empty + J % RING, lane);
      epi.template tile<0>(acc0, z, s);
      epi.template tile<1>(acc1, z, s);
""")]},
    "stores_in_flight": {"compact.cu": [("    if (M == 1 && out != nullptr) {",
                                         "    if (out != nullptr) {")]},
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
    """(csrc directory, the root's _build module, its plans of min2 and
    compact_mask)."""
    rb = load_module(root / "smafa_tpu_torch/ops/_build.py", f"_build_{tag}")
    m2 = load_module(root / "smafa_tpu_torch/ops/min2.py", f"_min2_{tag}")
    cm = load_module(root / "smafa_tpu_torch/ops/compact.py", f"_compact_{tag}")
    plans = (getattr(m2, "kernel_plan", m2.launch_plan),
             getattr(cm, "kernel_plan", m2.launch_plan))
    return root / "smafa_tpu_torch/csrc", rb, plans


def sources(roots, probes: bool, tmp: pathlib.Path) -> dict:
    """{build name: (csrc directory, _build module, plans)}: each root as
    it is, then the probe builds, edits of this checkout's sources."""
    out = {f"root{i}": checkout(root, f"root{i}") for i, root in enumerate(roots)}
    if probes:
        base = checkout(_HERE, "here")
        for name, edits in PROBES.items():
            d = tmp / name
            shutil.copytree(base[0], d)
            for src, reps in edits.items():
                text = (d / src).read_text()
                for a, b in reps:
                    if text.count(a) != 1:
                        raise SystemExit(f"probe {name}: {src} lacks its text")
                    text = text.replace(a, b)
                (d / src).write_text(text)
            out[name] = (d, base[1], base[2])
    return out


def build_all(builds: dict, tmp: pathlib.Path) -> dict:
    """{name: (library, ptxas lines, path, plans)}."""
    from smafa_tpu_torch.ops import _build

    procs = {}
    for name, (csrc, rb, plans) in builds.items():
        lib = tmp / f"libwg_{name}.so"
        procs[name] = (lib, plans, subprocess.Popen(
            [_build._nvcc(), *rb.COMPILE_FLAGS, *rb.LINK_FLAGS[2:],
             f"-I{csrc}", "-o", str(lib), str(csrc / "min2.cu"),
             str(csrc / "compact.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, plans, proc) in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"build {name} failed:\n{text}")
        ptxas, entry = [], None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            if "C75" in line or (entry and "_wg_kernel" in entry and (
                    "Used" in line or "spill" in line)):
                ptxas.append(line.strip())
        dll = ctypes.CDLL(str(lib))
        for fn in ("smafa_min2", "smafa_compact_mask"):
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
    ap.add_argument("--probes", action="store_true")
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

        def min2(name, q_emb, emb, zc, shift, s=None):
            dll, _, _, plans = libs[name]
            b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
            s = s or plans[0](b, wp, ep, sms)[1]
            out = torch.empty((3, b), dtype=torch.int32, device=dev)
            part = torch.empty((3, s, b), dtype=torch.int32, device=dev)
            rc = dll.smafa_min2(q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(),
                                out[0].data_ptr(), out[1].data_ptr(),
                                out[2].data_ptr(), part.data_ptr(), b, wp, ep,
                                L, shift, 1, s, stream)
            if rc:
                raise SystemExit(f"{name}: min2 launch failed: cudaError {rc}")
            return out

        def compact(name, q_emb, emb, zc, th, s=None):
            dll, _, _, plans = libs[name]
            b, wp, ep = q_emb.shape[0], emb.shape[0], q_emb.shape[1]
            s = s or plans[1](b, wp, ep, sms)[1]
            mask = torch.empty((b, wp // 32), dtype=torch.int32, device=dev)
            rc = dll.smafa_compact_mask(q_emb.data_ptr(), emb.data_ptr(),
                                        zc.data_ptr(), th.data_ptr(),
                                        mask.data_ptr(), b, wp, ep, L, s, stream)
            if rc:
                raise SystemExit(f"{name}: compact launch failed: cudaError {rc}")
            return mask

        def thresholds(b):
            return torch.from_numpy(rng.integers(0, 7, b).astype(np.int32)).to(dev)

        exact = {}
        kernels = [n for n in libs if n.startswith("root")]
        for n_rows, b, heavy in ((70001, 300, True), (5000, 77, False),
                                 (64, 1, False)):
            emb, zc, q_emb, shift = operands(n_rows, b, heavy)
            want = torch.stack(D.min2_reference(q_emb, emb, zc, L, shift, True))
            th = thresholds(b)
            want_mask = D.compact_mask_reference(q_emb, emb, zc, th, L)
            for name in kernels:
                ok = (torch.equal(min2(name, q_emb, emb, zc, shift), want)
                      and torch.equal(compact(name, q_emb, emb, zc, th),
                                      want_mask))
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
        qs = {b: q_emb[:b].contiguous() for b in (512, 4096, 8192)}
        ths = {b: thresholds(b) for b in (512, 4096, 8192)}
        cases = {"min2_32768": (lambda n: min2(n, q_emb, emb, zc, shift), 5),
                 "min2_4096": (lambda n: min2(n, qs[4096], emb, zc, shift), 20),
                 "min2_512": (lambda n: min2(n, qs[512], emb, zc, shift), 50),
                 "min2_heavy_4096": (lambda n: min2(n, q_h, emb_h, zc_h,
                                                    shift_h), 10)}
        for b in (4096, 8192, 512):
            cases[f"compact_{b}"] = (
                lambda n, b=b: compact(n, qs[b], emb, zc, ths[b]),
                50 if b == 512 else 10)
        times = {n: {c: [] for c in cases} for n in libs}
        for name in [*libs, *reversed(libs)]:
            for case, (fn, reps) in cases.items():
                times[name][case].append(time_ms(lambda: fn(name), reps))
        bound = {c: 2 * int(c.split("_")[-1]) * ROWS * 4 * L / PEAK_INT8_OPS * 1e3
                 for c in cases}
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
        print(json.dumps({"nvidia_smi": card, "roots": [str(r) for r in roots],
                          "exact": exact, "bound_ms": bound, "ms": times,
                          "bound_share": share, "splits_ms": sweep}))
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
