"""What the mask store costs compact_mask's short-route kernel on a card.

Builds libraries from smafa_tpu_torch/csrc/compact.cu with the port's
nvcc flags: the source as it is ("kept"), and a copy whose mask stores
are guarded by a condition that is never true at run time (``seq_len <
0``), so the compiler keeps the whole epilogue but nothing is written
("skipped"). With ``--baseline PATH`` it builds another version of
compact.cu the same two ways (the wgmma tile's stores, or the split
tile's one store of earlier versions), to compare two store schemes in
one call; every version runs at this checkout's plan's db splits.
Times every library on the same operands (L = 60, B query rows x 2^20 db
rows, thresholds 0-6) with CUDA events, in turns (the list, then the
list reversed), and checks that the kept libraries write the same mask.
Prints one JSON line with the card's name and power limit.

    python3 tools/torch_compact_store_probe.py [--queries 4096 8192]
                                               [--baseline PATH]

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

# The store guard of each version of compact.cu, the first found once:
# the wgmma tile's (its stores of a step), the split tile's (its one
# store of a tile).
STORES = (("if (M == 1 && out != nullptr) {",
           "if (M == 1 && out != nullptr && seq_len < 0) {"),
          ("*reinterpret_cast<uint2*>(out + ",
           "if (seq_len < 0) *reinterpret_cast<uint2*>(out + "))


def build(tmp: pathlib.Path, name: str, source: str) -> ctypes.CDLL:
    from smafa_tpu_torch.ops import _build

    src = tmp / f"{name}.cu"
    src.write_text(source)
    lib = tmp / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
                    f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    dll.smafa_compact_mask.argtypes = _build._SIGNATURES["smafa_compact_mask"]
    dll.smafa_compact_mask.restype = ctypes.c_int
    return dll


def variants(name: str, path: pathlib.Path) -> dict[str, str]:
    """The source as it is, and with its mask stores never taken."""
    source = path.read_text()
    for guard, never in STORES:
        if source.count(guard) == 1:
            return {f"{name}_kept": source,
                    f"{name}_skipped": source.replace(guard, never)}
    raise SystemExit(f"{path}: the mask store is not found once")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, nargs="+", default=[4096, 8192])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--baseline", type=pathlib.Path,
                    help="another version of compact.cu to time beside it")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    from smafa_tpu_torch.ops import compact, distance as D

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sources = variants("source", _ROOT / "smafa_tpu_torch" / "csrc" / "compact.cu")
    if args.baseline is not None:
        sources.update(variants("baseline", args.baseline))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    L, n = 60, 1 << 20
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, (n, L), dtype=np.uint8)).to(dev)
    db_emb, zc = D.embed_db(codes, L, n)
    out = {"nvidia_smi": card, "L": L, "W": n, "reps": args.reps, "runs": []}
    with tempfile.TemporaryDirectory(prefix="store_probe_") as tmp:
        libs = {name: build(pathlib.Path(tmp), name, src)
                for name, src in sources.items()}
        for b in args.queries:
            q = codes[torch.from_numpy(rng.integers(0, n, b)).to(dev)]
            q_emb = D.expand_embed_query(q, L)
            thresh = torch.from_numpy(rng.integers(0, 7, b).astype(np.int32)).to(dev)
            mask = torch.empty((b, n // 32), dtype=torch.int32, device=dev)
            _, splits = compact.kernel_plan(b, n, q_emb.shape[1], sms)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch(lib):
                rc = lib.smafa_compact_mask(
                    q_emb.data_ptr(), db_emb.data_ptr(), zc.data_ptr(),
                    thresh.data_ptr(), mask.data_ptr(), b, n, q_emb.shape[1],
                    L, splits, stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            masks = {}
            for name in libs:
                if name.endswith("_kept"):
                    mask.zero_()
                    launch(libs[name])
                    masks[name] = mask.clone()
            same = all(torch.equal(m, masks["source_kept"]) for m in masks.values())
            times: dict[str, list[float]] = {name: [] for name in libs}
            for name in [*libs, *reversed(libs)]:
                launch(libs[name])  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    launch(libs[name])
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / args.reps)
            out["runs"].append({"B": b, "splits": splits, "mask_bytes": b * n // 8,
                                "kept_masks_equal": same, "ms": times})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
