"""What sets the pace of the hist kernel (csrc/hist.cu) on a card: the
kernel as it is, and two probe builds of the same source, timed in turns
at the K-mode shapes of chip_smoke.py.

Each ``--root`` (a checkout; this one unless given, and given more than
once for a change against its parent in one call) has its
``smafa_tpu_torch/csrc/hist.cu`` built alone into a library with the
plain C entry ``smafa_hist`` (one nvcc a build, all started together,
with the root's own ``ops/_build.py`` flags). Where the source holds the
probe macros it is also built with

- ``-DHIST_PROBE_PRODUCT_ONLY``: the product as it is, the tally
  replaced by a register sum of the bins (no shared-memory increment);
- ``-DHIST_PROBE_TALLY_ONLY``: the copies and the tally as they are,
  the product replaced by scores made from zc and the row and column
  indices, spread over the bins about L/4 as a random read's scores
  against random windows;
- ``-DHIST_PROBE_COPIES_ONLY``: neither product nor tally, the copies
  and the ring's waits alone.

A macro a source does not hold leaves that build equal to the kernel;
the program never sets any of them; the probe builds give wrong
histograms by design and are timed only. The plain build of each root
is held exactly to ``hist_reference`` (this checkout's plain version).
The db splits are each root's own ``ops/hist.py`` ``launch_plan``.

Shapes (B reads x rows, L): 16384 x (2^20 + 37) at 60 bp (the K-mode
smoke's batch, split tile), 4096 x 2,621,440 at 150 bp (phase 9's K =
99 batch against one slab, "kchunk"), 1024 x 32,768 at 300 and 1023 bp
("kchunk_stream"). The db is random codes 0-3 with a tenth of its rows
copies of row 3; reads are db rows with about 5% substitutions, the
first 4 copies of row 3; all from --seed on the card. Every build is
timed by CUDA events over back-to-back calls, in the order of the roots
and then in reverse (parent, change, change, parent for two roots).

``--sass`` also prints, for each plain build, the count of its SASS
lines naming warpgroup MMA (``WGMMA``/``HGMMA``/``IGMMA``) and TMA loads
(``UTMALDG``) and the first few of each (``cuobjdump -sass``, where the
toolkit has it).

    python3 tools/torch_hist_probe.py [--root DIR ...] [--only 60 150 300 1023]
        [--no-variants] [--sass] [--seed N]

Needs a CUDA device and nvcc; run from anywhere. Prints the card's name
and power limit; exits 1 if a plain build differs from the plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

_HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_HERE))

# (L, B, rows, reps)
SHAPES = [(60, 16384, (1 << 20) + 37, 5), (150, 4096, 2_621_440, 3),
          (300, 1024, 32768, 20), (1023, 1024, 32768, 10)]
VARIANTS = {"kernel": [], "product_only": ["-DHIST_PROBE_PRODUCT_ONLY"],
            "tally_only": ["-DHIST_PROBE_TALLY_ONLY"],
            "copies_only": ["-DHIST_PROBE_COPIES_ONLY"]}
PEAK_INT8_OPS = 1.979e15  # H100 SXM dense int8 tensor-core peak, op/s
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
SASS_KEYS = {"warpgroup_mma": ("WGMMA", "HGMMA", "IGMMA"),
             "tma_load": ("UTMALDG",)}


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


def build_all(roots: list[pathlib.Path], variants: bool,
              tmp: pathlib.Path) -> dict:
    """{(root index, variant): (smafa_hist, ptxas lines, library path)}."""
    from smafa_tpu_torch.ops import _build

    procs = {}
    for i, root in enumerate(roots):
        rb = load_module(root / "smafa_tpu_torch/ops/_build.py", f"_build_root{i}")
        csrc = root / "smafa_tpu_torch/csrc"
        src = csrc / "hist.cu"
        text = src.read_text()
        for name, flags in VARIANTS.items():
            if name != "kernel" and not (variants and flags[0][2:] in text):
                continue
            lib = tmp / f"libhist_{i}_{name}.so"
            procs[(i, name)] = (lib, subprocess.Popen(
                [_build._nvcc(), *rb.COMPILE_FLAGS, *flags, *rb.LINK_FLAGS,
                 f"-I{csrc}", "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, proc) in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"hist.cu of root {key[0]} ({key[1]}) did not "
                             f"build:\n{text}")
        ptxas = [line.strip() for line in text.splitlines()
                 if "entry function" in line or "Used" in line
                 or "spill" in line or "Warning" in line or "warning" in line
                 or "C75" in line]
        fn = ctypes.CDLL(str(lib)).smafa_hist
        fn.argtypes = _build._SIGNATURES["smafa_hist"]
        fn.restype = ctypes.c_int
        out[key] = fn, ptxas, lib
    return out


def sass_lines(lib: pathlib.Path) -> dict:
    """Counts and first lines of the library's warpgroup MMA and TMA
    load instructions; "not measured" without cuobjdump."""
    from smafa_tpu_torch.ops import _build

    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        found = shutil.which("cuobjdump")
        if found is None:
            return {"sass": "not measured (no cuobjdump)"}
        tool = pathlib.Path(found)
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    res = {}
    for key, words in SASS_KEYS.items():
        hits = [ln.strip() for ln in text.splitlines()
                if any(w in ln for w in words)]
        res[key] = {"count": len(hits), "first": hits[:4]}
    return res


def operands(torch, D, L: int, b: int, rows: int, seed: int, dev):
    """(db_emb, zc, q_emb) for one shape, made on the card."""
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
    return emb, zc, D.expand_embed_query(q, L)


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


def bound(b: int, rows: int, L: int, ep: int) -> tuple[float, str]:
    """chip_smoke.py's bound of one hist call: int8 operations or bytes
    (queries, db rows and zc read once, the histogram written once)."""
    t_ops = 2 * b * rows * 4 * L / PEAK_INT8_OPS * 1e3
    t_bytes = (b * ep + rows * (ep + 4) + 4 * b * (L + 1)) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, action="append")
    ap.add_argument("--only", type=int, nargs="+", default=[60, 150, 300, 1023])
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    roots = [r.resolve() for r in (args.root or [_HERE])]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    from smafa_tpu_torch.ops import distance as D, min2 as M

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = M.sm_count(dev)
    plans = [load_module(r / "smafa_tpu_torch/ops/hist.py", f"hist_root{i}")
             for i, r in enumerate(roots)]
    bad = []
    with tempfile.TemporaryDirectory(prefix="hist_probe_") as tmp:
        libs = build_all(roots, not args.no_variants, pathlib.Path(tmp))
        print(json.dumps({"ptxas": {f"{k[0]}:{k[1]}": p
                                    for k, (_, p, _) in libs.items()}}),
              flush=True)
        if args.sass:
            print(json.dumps({"sass": {str(i): sass_lines(libs[(i, "kernel")][2])
                                       for i in range(len(roots))}}),
                  flush=True)
        order = list(range(len(roots)))
        order += order[::-1]
        for L, b, rows, reps in SHAPES:
            if L not in args.only:
                continue
            emb, zc, q_emb = operands(torch, D, L, b, rows, args.seed, dev)
            ep = q_emb.shape[1]
            want = D.hist_reference(q_emb, emb, zc, rows, L)
            out = torch.empty_like(want)
            stream = torch.cuda.current_stream(dev).cuda_stream
            times, exact, plan_of = {}, {}, {}
            for i in order:
                plan = plans[i].launch_plan(b, rows, L, sms)
                plan_of[i] = plan._asdict()
                for (ri, name), (fn, _, _) in libs.items():
                    if ri != i:
                        continue

                    def call(fn=fn, s=plan.splits):
                        rc = fn(q_emb.data_ptr(), emb.data_ptr(), zc.data_ptr(),
                                out.data_ptr(), b, rows, ep, L, s, stream)
                        if rc:
                            raise RuntimeError(f"root {i} {name}: cudaError {rc}")

                    if name == "kernel":
                        out.fill_(-7)
                        call()
                        torch.cuda.synchronize()
                        exact[i] = exact.get(i, True) and torch.equal(out, want)
                    times.setdefault(f"{i}:{name}", []).append(
                        events_ms(torch, call, reps))
            bnd, by = bound(b, rows, L, ep)
            line = {"L": L, "B": b, "rows": rows, "bound_ms": bnd,
                    "bound_by": by, "ms": times,
                    "share": {k: bnd / min(v) for k, v in times.items()},
                    "exact": exact, "plan": plan_of, "reps": reps}
            print(json.dumps(line), flush=True)
            bad += [i for i, ok in exact.items() if not ok]
            del emb, zc, q_emb, want, out
            torch.cuda.empty_cache()
    print(json.dumps({"roots": [str(r) for r in roots], "nvidia_smi": card_name(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
