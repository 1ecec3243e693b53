"""The best-hit query smoke of one or more trees of this repository, one
fresh process each, on one card.

Runs chip_smoke.py's end-to-end phase (makedb --format native of a
seeded 2^20-window 60 bp db, then best-hit query of 65,536 reads at
--max-divergence 5 through the CLI) from each tree given, in the order
given, each in its own process with its own kernel build, and prints one
JSON line per run: wall, scan and stage seconds, kernel launches. The
sampled brute-force check covers --sample reads (chip_smoke.py: 512, at
~0.2 s a read). To compare a change with its parent on one card, unpack
the parent into a git-ignored directory and run parent, change, change,
parent:

    git archive HEAD | tar -x -C _parent_tmp
    python3 tools/torch_query_smoke_ab.py _parent_tmp . . _parent_tmp

Each tree's chip_smoke.py must have the phase ``end_to_end(sizes, cli,
query_mod, min2_mod, compact_mod, rng, tmp)``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def run_one(tree: str, sample: int) -> dict:
    """The phase from ``tree``, in this process."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np

    import chip_smoke
    import smafa_tpu_torch
    from smafa_tpu_torch import cli
    from smafa_tpu_torch.engine import query as query_mod
    from smafa_tpu_torch.ops import _build, compact, min2

    if not smafa_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {smafa_tpu_torch.__file__}, not {root}")
    _build.load()
    sizes = chip_smoke.smoke_sizes(query_mod)
    sizes.sample = sample
    with tempfile.TemporaryDirectory(prefix="smafa_ab_") as tmp:
        res, _, _ = chip_smoke.end_to_end(sizes, cli, query_mod, min2, compact,
                                          np.random.default_rng(0), tmp)
    return {"tree": tree, **{k: res[k] for k in (
        "query_wall_s", "scan_s", "stage_s", "launches", "sampled_exact")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="roots of checkouts, in run order")
    ap.add_argument("--sample", type=int, default=32)
    ap.add_argument("--run-one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run_one:
        print("RESULT " + json.dumps(run_one(args.trees[0], args.sample)))
        return 0
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run-one",
             "--sample", str(args.sample), tree],
            capture_output=True, text=True, check=True, timeout=1200)
        print(next(line[len("RESULT "):] for line in out.stdout.splitlines()
                   if line.startswith("RESULT ")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
