"""The ``cuda`` fixture and operands of the card tests
(``tests/test_torch_gpu*.py``, marker ``gpu``). pytest does not collect
this module; each card test file imports the fixture from it.

It imports no jax, and torch only inside the fixture, not at collection:
a worker that imported torch passes its resident size on to every
subprocess it starts (ru_maxrss survives exec), which
tests/test_chunked_ingest.py measures. On a machine with a card (which
need not have jax) run the card tests with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smafa_tpu_torch.engine import cluster
    from smafa_tpu_torch.engine import query
    from smafa_tpu_torch.ops import (compact, distance, hist, keys, kstats,
                                     min2, min_count)
    from smafa_tpu_torch.parallel.runner import ScanRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    return types.SimpleNamespace(
        dev=torch.device("cuda"), torch=torch, C=compact, D=distance,
        HI=hist, K=keys, KS=kstats, M=min2, MC=min_count,
        ScanRunner=ScanRunner, CL=cluster, Q=query)


def operands(g, seq_len, nw, b, seed):
    """(db_emb, zc, q_emb, shift) on the card: nw random rows over codes
    0-4 padded to the 64-row tile, a tenth of them copies of row 3, and b
    queries mutated off db rows, the first 4 exact copies of row 3."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (nw, seq_len), dtype=np.uint8)
    codes[rng.integers(0, nw, nw // 10)] = codes[3]  # ties
    q = codes[rng.integers(0, nw, b)].copy()
    mut = rng.random(q.shape) < 0.05
    q[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    q[:4] = codes[3]
    wp = -(-nw // WP_MULTIPLE) * WP_MULTIPLE
    emb, zc = g.D.embed_db(g.torch.from_numpy(codes).to(g.dev), seq_len, wp)
    q_emb = g.D.expand_embed_query(g.torch.from_numpy(q).to(g.dev), seq_len)
    return emb, zc, q_emb, g.K.packing_shift(seq_len, wp)
