"""The ring and column layouts on the card: ``RingRunner`` and
``ColumnShardedRunner`` on CUDA tensors give what ``ScanRunner`` gives
with the plain versions on the CPU, every hit mode, over one rank
(``LocalComm``) and over two ranks sharing ``cuda:0`` through gloo
(``Comm`` stages CUDA tensors through pinned host memory, ``rotate``
included); the ring launches the min2, kstats and compact_mask kernels.
The ring with two batches in flight, as the query engine runs them
(each batch's first pass on the runner's side stream while the batch
before compacts on the current stream, each stream embedding the
arriving shards into a buffer of its own): as rank 0 of 3 on one card,
its peers stood in for, and, on a host with three cards or more, as
three ranks over NCCL.

Marked ``gpu``: each test skips where no CUDA device is visible. Run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``; the
``cuda`` fixture is in tests/torch_gpu_common.py.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_gpu_common import cuda  # noqa: F401

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parent.parent

# A seeded db with duplicate groups across the 2-rank shard edge and reads
# off it, every hit mode of a runner, and the check against ScanRunner on
# the CPU: shared by the tests and the two-rank workers.
# (Collecting imports no torch: tests/torch_gpu_common.py says why.)
COMMON = """
import numpy as np

def make_db(seed, n, nq, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (n, L), dtype=np.uint8)
    for start, g in ((n // 2 - 4, 9), (100, 40), (7, 3)):
        codes[start:start + g] = codes[start]
    q = codes[rng.integers(0, n, nq)].copy()
    q[:3] = codes[[n // 2 - 4, 100, 7]]
    mut = rng.random(q.shape) < 0.04
    mut[:3] = False
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    return codes, q

def modes(runner, q, L):
    out = [runner.best_hit(q), runner.best_hit(q, max_divergence=L // 20)]
    for k, md in ((99, None), (7, L // 15), (5000, None)):
        out.append(runner.kmode_flat(q, k, md))
    return out

def check(cls, codes, q, L, comm):
    import torch

    from smafa_tpu_torch.parallel.runner import ScanRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    want = modes(ScanRunner(codes, L, torch.device("cpu")), q, L)
    got = modes(cls(codes, L, torch.device("cuda"), comm=comm), q, L)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
"""
exec(COMMON)

WORKER = COMMON + """
import json
import sys

import torch
import torch.distributed as dist
from smafa_tpu_torch.ops import compact, kstats, min2
from smafa_tpu_torch.parallel.comm import Comm
from smafa_tpu_torch.parallel.ring import RingRunner
from smafa_tpu_torch.parallel.seqpar import ColumnShardedRunner

rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
comm = Comm(rank, 2, dist.group.WORLD, dist.group.WORLD, False)
t = torch.arange(6, device="cuda", dtype=torch.int32).reshape(2, 3) + 10 * rank
got = comm.rotate(t)
assert got.is_cuda and got.tolist() == (
    torch.arange(6).reshape(2, 3) + 10 * (1 - rank)).tolist(), got
codes, q = make_db(1, 5000, 300, 60)
check(RingRunner, codes, q, 60, comm)
launches = [min2.launches, kstats.launches, compact.launches]
codes, q = make_db(2, 700, 70, 300)
check(ColumnShardedRunner, codes, q, 300, comm)
print(json.dumps({"launches": launches}))
dist.destroy_process_group()
"""


# Three ranks, one card each, device collectives over NCCL: the ring with
# two batches in flight (engine.query._scan_stream's order) against
# ScanRunner on the same card, batch by batch.
NCCL_WORKER = """
import json
import sys

import numpy as np
import torch
from smafa_tpu_torch.ops import compact, kstats, min2
from smafa_tpu_torch.parallel import multihost
from smafa_tpu_torch.parallel.ring import RingRunner
from smafa_tpu_torch.parallel.runner import ScanRunner

rank, port, n = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
dev = multihost.initialize(f"127.0.0.1:{port}", n, rank,
                           torch.device("cuda"))
comm = multihost.comm()
assert comm.device_nccl and dev.index == rank, (comm.device_nccl, dev)
t = torch.full((3,), rank, device=dev, dtype=torch.int32)
assert comm.rotate(t).tolist() == [(rank - 1) % n] * 3
# every row one of W / 8 base rows, so nearly every read ties past 2
L, W, batches = 60, n * (1 << 17), 6
rng = np.random.default_rng(5)
base = rng.integers(0, 4, (W // 8, L), dtype=np.uint8)
codes = base[rng.integers(0, W // 8, W)]
q = codes[rng.integers(0, W, batches * 2048)].copy()
mut = rng.random(q.shape) < 0.02
q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
qs = np.split(q, batches)
ring, ref = RingRunner(codes, L, dev, comm=comm), ScanRunner(codes, L, dev)
modes = [(ring.min_count_async, lambda b, h: ring.best_hit(b, handle=h),
          ref.best_hit),
         (lambda b: ring.kmode_stats_async(b, 99, 6),
          lambda b, h: ring.kmode_flat(b, 99, 6, stats_handle=h),
          lambda b: ref.kmode_flat(b, 99, 6))]
min2.launches = kstats.launches = compact.launches = 0
bad = 0
for launch, finish, want in modes:
    pending = None
    for b in [*qs, None]:
        current = None if b is None else (b, launch(b))
        if pending is not None:
            got, exp = finish(*pending), want(pending[0])
            bad += not all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(got, exp))
        pending = current
print(json.dumps({"bad_batches": bad, "streams": len(ring._arriving),
                  "rotations": ring.rotations,
                  "launches": [min2.launches, kstats.launches,
                               compact.launches]}))
multihost.shutdown()
"""


def test_ring_three_ranks_nccl_batches_in_flight(cuda):
    """Three ranks on cards of their own (NCCL): every batch of both hit
    modes, launched one ahead, equals ScanRunner's on the same card, and
    each rank swept on two streams."""
    n = 3
    if cuda.torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_WORKER, str(r),
                               str(port), str(n)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT) for r in range(n)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        res = json.loads(out.strip().splitlines()[-1])
        assert res["bad_batches"] == 0, res
        assert res["streams"] == 2 and res["rotations"] > 0, res
        assert all(k > 0 for k in res["launches"]), res


class PeerShards:
    """Rank 0 of a ring of 3 whose peers are stood in for: ``rotate``
    passes the shards of ranks 2 and 1 in ring order (already on the
    card), and the gathers give every rank this rank's block, so only
    its block's rows come out right."""

    rank, size, device_nccl, card_ranks = 0, 3, True, 1

    def __init__(self, shards):
        self.shards, self.rotations = shards, 0

    def rotate(self, t):
        self.rotations += 1  # a sweep's first hop brings rank 2's shard
        return self.shards[2 if self.rotations % 2 else 1]

    def all_gather(self, t):
        return [t] * self.size

    def gather_var(self, t):
        return [t] + [t[:0]] * (self.size - 1)

    def all_reduce(self, t, op):
        return t


def test_ring_streams_keep_their_arriving_shards(cuda, monkeypatch):
    """Rank 0 of a ring of 3 on one card (``PeerShards``), every read in
    its block, two batches in flight in both hit modes. Each embedding
    of an arriving shard on the side stream waits ~20 ms first, and each
    on the current stream is followed by ~50 ms before the compaction
    reads it, so the side stream embeds while the current stream's
    compaction waits: each batch equals ScanRunner's on the card."""
    import numpy as np

    from smafa_tpu_torch.parallel.ring import RingRunner

    torch = cuda.torch
    L, n, nq = 60, 3 * 4096, 256
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, (n // 8, L), dtype=np.uint8)
    codes = base[rng.integers(0, n // 8, n)]
    q = codes[rng.integers(0, n, 3 * nq)].copy()
    mut = rng.random(q.shape) < 0.02
    q[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.uint8)
    qs = np.split(q, 3)
    shards = [torch.from_numpy(codes[k * 4096:(k + 1) * 4096]).to(cuda.dev)
              for k in range(3)]
    ring = RingRunner(codes, L, cuda.dev, comm=PeerShards(shards))
    assert ring.shard_rows == 4096

    def pad(q_codes):  # every read in rank 0's block, a third of the batch
        q_padded, nq_, b = cuda.K.pad_batch(q_codes, minimum=16)
        return np.pad(q_padded, ((0, 2 * b), (0, 0))), nq_
    ring._pad = pad
    real = cuda.D.embed_db_into

    def slow_embed(*args):
        side = torch.cuda.current_stream() != torch.cuda.default_stream()
        if side:
            torch.cuda._sleep(40_000_000)
        real(*args)
        if not side:
            torch.cuda._sleep(100_000_000)
    monkeypatch.setattr(cuda.D, "embed_db_into", slow_embed)
    ref = cuda.ScanRunner(codes, L, cuda.dev)
    cuda.M.launches = cuda.KS.launches = cuda.C.launches = 0
    for launch, finish, want in (
            (ring.min_count_async,
             lambda b, h: ring.best_hit(b, handle=h), ref.best_hit),
            (lambda b: ring.kmode_stats_async(b, 99, 6),
             lambda b, h: ring.kmode_flat(b, 99, 6, stats_handle=h),
             lambda b: ref.kmode_flat(b, 99, 6))):
        pending = None
        for b in [*qs, None]:
            current = None if b is None else (b, launch(b))
            if pending is not None:
                for x, y in zip(finish(*pending), want(pending[0])):
                    np.testing.assert_array_equal(np.asarray(x),
                                                  np.asarray(y))
            pending = current
    assert len(ring._arriving) == 2 and ring.rotations > 0
    assert cuda.M.launches and cuda.KS.launches and cuda.C.launches


@pytest.mark.parametrize("L", [60, 150])
def test_ring_one_rank_on_card(cuda, L):
    from smafa_tpu_torch.parallel.comm import LocalComm
    from smafa_tpu_torch.parallel.ring import RingRunner

    codes, q = make_db(L, 20000, 500, L)
    cuda.M.launches = cuda.KS.launches = cuda.C.launches = 0
    check(RingRunner, codes, q, L, LocalComm())
    assert cuda.M.launches > 0 and cuda.KS.launches > 0
    assert cuda.C.launches > 0


@pytest.mark.parametrize("L", [150, 300, 8192])
def test_col_one_rank_on_card(cuda, L):
    from smafa_tpu_torch.parallel.comm import LocalComm
    from smafa_tpu_torch.parallel.seqpar import ColumnShardedRunner

    codes, q = make_db(L, 3000, 200, L)
    check(ColumnShardedRunner, codes, q, L, LocalComm())


def test_two_ranks_share_the_card(cuda):
    """Two processes on cuda:0 over gloo: rotate stages CUDA tensors, and
    both layouts equal the CPU's ScanRunner on every rank."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert all(n > 0 for n in json.loads(out)["launches"])
