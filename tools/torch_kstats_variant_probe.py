"""Where the kstats split kernel keeps its per-row state, and how it
counts, measured on a card.

Builds libraries from smafa_tpu_torch/csrc/kstats.cu with the port's
nvcc flags, one nvcc each, all started together: the source as it is
("byte_lanes": four probes counted in the bytes of one register below
64 bp, two blocks per SM), and copies patched to count 16-bit pairs
with a compare and a predicated add per probe ("count_pairs"), to hold
the counts as four ints a row ("int_counts"), to build for one block per
SM ("..._1_block"), or to read the int counts' bounds from shared memory
once a tile ("bounds_in_smem"). Keeps each build's ``ptxas -v`` lines of
kstats_split_kernel (registers, spills), of both its instantiations
(``<true>`` counts in byte lanes, ``<false>`` does not; at L = 60 the
"count_pairs", "int_counts" and "bounds_in_smem" builds run
``<false>``). Then, on the same operands (L = 60, B query rows x
2^20 + 37 db rows, thresholds in [-1, 60]), checks that every library
equals the plain version (``distance.stats_reference``) exactly and
times each with CUDA events, in turns (the list, then the list
reversed). Each library's db splits come from ``ops/min2.py``'s
``split_count`` over the live tiles with its own blocks per SM. Prints
one JSON line with the card's name and power limit.

    python3 tools/torch_kstats_variant_probe.py [--queries 16384 4096 300]

Needs a CUDA device and nvcc; run from anywhere.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))

SOURCE = _ROOT / "smafa_tpu_torch" / "csrc" / "kstats.cu"

# (text of kstats.cu, its replacement) pairs; each text must occur once
ONE_BLOCK = [("__launch_bounds__(S_THREADS, S_BLOCKS_PER_SM)",
              "__launch_bounds__(S_THREADS, 1)")]
PAIRS = [("const bool bytes = seq_len < 64;", "const bool bytes = false;")]
INTS = PAIRS + [
    ("using Pairs = int[4][2];", "using Pairs = int[4][PROBES];"),
    ("add_if_ge(cnt[i][p >> 1], s[c], bound[i][p], p & 1 ? 0x10000 : 1);",
     "add_if_ge(cnt[i][p], s[c], bound[i][p], 1);"),
    ("c[p] = (cnt[i][p >> 1] >> (16 * (p & 1))) & 0xffff;",
     "c[p] = cnt[i][p];")]
SMEM_BOUNDS = INTS + [
    ("const int smem = split_smem(EP);",
     "const int smem = split_smem(EP) + S_BM * (int)sizeof(int4);"),
    # thread x computes block row x's bounds; the loop's first sync
    # publishes them
    ("    return row_bound<BYTES>(ts, row, B, p, seq_len);\n  };\n",
     "    return row_bound<BYTES>(ts, row, B, p, seq_len);\n  };\n"
     "  int4* sBound = reinterpret_cast<int4*>(ring + S_STAGES * sbytes);\n"
     "  sBound[threadIdx.x] = make_int4(\n"
     "      bound_of(b0 + threadIdx.x, 0), bound_of(b0 + threadIdx.x, 1),\n"
     "      bound_of(b0 + threadIdx.x, 2), bound_of(b0 + threadIdx.x, 3));\n"),
    ("const int* sZ = reinterpret_cast<const int*>(sD + S_BN * stride);\n",
     "const int* sZ = reinterpret_cast<const int*>(sD + S_BN * stride);\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 4; ++i) {\n"
     "        const int4 v = sBound[warp * 32 + g + 8 * i];\n"
     "        bound[i][0] = v.x; bound[i][1] = v.y;\n"
     "        bound[i][2] = v.z; bound[i][3] = v.w;\n"
     "      }\n")]

# name -> (patches, blocks per SM)
VARIANTS = {"byte_lanes": ([], 2), "byte_lanes_1_block": (ONE_BLOCK, 1),
            "count_pairs": (PAIRS, 2), "int_counts": (INTS, 2),
            "int_counts_1_block": (INTS + ONE_BLOCK, 1),
            "bounds_in_smem": (SMEM_BOUNDS, 2)}


def patched(patches: list[tuple[str, str]]) -> str:
    source = SOURCE.read_text()
    for old, new in patches:
        if source.count(old) != 1:
            raise SystemExit(f"{SOURCE}: {old!r} is not found once")
        source = source.replace(old, new)
    return source


def build_all(tmp: pathlib.Path) -> dict[str, tuple[ctypes.CDLL, list[str]]]:
    """Every variant's library (one nvcc each, all started together) and
    its ptxas lines of the split kernel."""
    from smafa_tpu_torch.ops import _build

    procs = {}
    for name, (patches, _) in VARIANTS.items():
        src = tmp / f"{name}.cu"
        src.write_text(patched(patches))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
             f"-I{_build.CSRC}", "-o", str(tmp / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{name} did not build:\n{text}")
        ptxas, take = [], False
        for line in text.splitlines():
            if "Compiling entry function" in line:
                take = "kstats_split_kernel" in line
            if take and ("entry function" in line or "Used" in line
                         or "spill" in line):
                ptxas.append(line.strip())
        dll = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        dll.smafa_kstats.argtypes = _build._SIGNATURES["smafa_kstats"]
        dll.smafa_kstats.restype = ctypes.c_int
        out[name] = dll, ptxas
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, nargs="+", default=[16384, 4096])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    from smafa_tpu_torch.ops import distance as D, keys as K, min2 as M

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    L, n = 60, (1 << 20) + 37
    wp = -(-n // D.WP_MULTIPLE) * D.WP_MULTIPLE
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, (n, L), dtype=np.uint8)).to(dev)
    db_emb, zc = D.embed_db(codes, L, wp)
    out = {"nvidia_smi": card, "L": L, "W": n, "reps": args.reps,
           "variants": {}, "runs": []}
    with tempfile.TemporaryDirectory(prefix="kstats_probe_") as tmp:
        libs = {}
        for name, (lib, ptxas) in build_all(pathlib.Path(tmp)).items():
            libs[name] = lib
            out["variants"][name] = {"blocks_per_sm": VARIANTS[name][1],
                                     "ptxas": ptxas}
        for b in args.queries:
            q = codes[torch.from_numpy(rng.integers(0, n, b)).to(dev)]
            q_emb = D.expand_embed_query(q, L)
            ts = torch.from_numpy(rng.integers(
                -1, L + 1, (K.KSTATS_PROBES, b)).astype(np.int32)).to(dev)
            want = D.stats_reference(q_emb, db_emb, zc, ts, n, L)
            cnt = torch.empty_like(want[0])
            mx = torch.empty_like(want[1])
            stream = torch.cuda.current_stream(dev).cuda_stream
            splits = {name: M.split_count(b, wp, sms * blocks)
                      for name, (_, blocks) in VARIANTS.items()}
            parts = {name: torch.empty((K.KSTATS_PROBES + 1, s, b),
                                       dtype=torch.int32, device=dev)
                     for name, s in splits.items()}

            def launch(name):
                rc = libs[name].smafa_kstats(
                    q_emb.data_ptr(), db_emb.data_ptr(), zc.data_ptr(),
                    ts.data_ptr(), cnt.data_ptr(), mx.data_ptr(),
                    parts[name].data_ptr(), b, n, q_emb.shape[1], L,
                    splits[name], stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed, cudaError {rc}")

            exact = {}
            for name in libs:
                cnt.fill_(-7)
                mx.fill_(-7)
                launch(name)
                torch.cuda.synchronize()
                exact[name] = bool(torch.equal(cnt, want[0])
                                   and torch.equal(mx, want[1]))
            times: dict[str, list[float]] = {name: [] for name in libs}
            for name in [*libs, *reversed(libs)]:
                launch(name)  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    launch(name)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / args.reps)
            out["runs"].append({"B": b, "splits": splits, "exact": exact,
                                "ms": times})
            if not all(exact.values()):
                print(json.dumps(out))
                raise SystemExit(f"a variant differs from the plain version at B={b}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
