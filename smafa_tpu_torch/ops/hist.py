"""Wrapper of the hist kernel (``csrc/hist.cu``), the K-mode distance
histogram: one pass over the db gives every row's cutoff and hit count
(``distance.kmode_cutoffs_from_hist``), where the kstats search takes
``kstats_steps(L)`` passes.

CPU tensors take the plain version (``distance.hist_reference``); CUDA
tensors launch the kernel on the current stream, or raise. ``launches``
counts calls that launched the kernel (one per call; none when there is
nothing to scan).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smafa_tpu_torch.ops import _build
from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import min2 as M
from smafa_tpu_torch.ops.keys import HIST_MAX

launches = 0

# The kernel's routes (csrc/hist.cu), by embedding width: (route, the
# widest EP it takes, query rows a block, db rows a step, bins two to an
# int32 word). One block an SM on every route.
ROUTES = (("split", M.SPLIT_EP_MAX, 256, 64, False),
          ("kchunk", M.RESIDENT_EP_MAX, 128, 128, False),
          ("kchunk_stream", None, 64, 256, True))


class Plan(NamedTuple):
    route: str
    splits: int
    block_rows: int   # query rows a block
    bin_bytes: int    # shared bytes of a block's bins


def launch_plan(b: int, n_valid: int, seq_len: int, sms: int) -> Plan:
    """The hist kernel's launch on a card with ``sms`` SMs: its route by
    the embedding width, and db splits S of the grid (ceil(b / rows a
    block) query tiles x S): 1 when the query tiles fill the SMs, else
    as many as fit beside them, never more than the steps over the
    first ``n_valid`` db rows. ("none", 0, ...) when there is nothing to
    scan (b == 0 or n_valid == 0), which launches nothing."""
    ep = D.embed_width(seq_len)
    route, _, rows, step, pairs = next(
        r for r in ROUTES if r[1] is None or ep <= r[1])
    words = (seq_len + 2) // 2 if pairs else seq_len + 1
    bin_bytes = 4 * rows * words
    if b == 0 or n_valid == 0:
        return Plan("none", 0, rows, bin_bytes)
    qtiles, steps = -(-b // rows), -(-n_valid // step)
    splits = 1 if qtiles >= sms else max(1, min(steps, sms // qtiles))
    return Plan(route, splits, rows, bin_bytes)


def hist(q_emb: torch.Tensor, db_emb: torch.Tensor, zc: torch.Tensor,
         n_valid: int, seq_len: int) -> torch.Tensor:
    """int32 [B, L+1] distance histogram over db rows < n_valid: see
    ``distance.hist_reference``. Windows of at most HIST_MAX - 1 bp.

    The operands must be the port's embeddings (``distance.embed_db`` and
    ``distance.expand_embed_query``), which ``check_operands`` checks by
    shape and type only: the kernel relies on every score q . db + zc of
    a row below n_valid lying in [0, L], and bins one outside it at the
    nearer end."""
    global launches
    M.check_operands(q_emb, db_emb, zc, seq_len)
    if seq_len >= HIST_MAX:
        raise ValueError(f"the histogram takes windows below {HIST_MAX} bp, "
                         f"not {seq_len}")
    if not 0 <= n_valid <= db_emb.shape[0]:
        raise ValueError(f"n_valid ({n_valid}) must lie in "
                         f"[0, {db_emb.shape[0]}]")
    if q_emb.device.type == "cpu":
        return D.hist_reference(q_emb, db_emb, zc, n_valid, seq_len)
    if not q_emb.is_cuda:
        raise ValueError(f"no hist kernel for device {q_emb.device}")
    b = q_emb.shape[0]
    plan = launch_plan(b, n_valid, seq_len, M.sm_count(q_emb.device))
    out = torch.empty((b, seq_len + 1), dtype=torch.int32,
                      device=q_emb.device)
    if plan.splits == 0:
        return out.zero_()
    lib = _build.load()
    stream = torch.cuda.current_stream(q_emb.device).cuda_stream
    rc = lib.smafa_hist(q_emb.data_ptr(), db_emb.data_ptr(), zc.data_ptr(),
                        out.data_ptr(), b, n_valid, q_emb.shape[1], seq_len,
                        plan.splits, stream)
    _build.check(rc, "hist")
    launches += 1
    return out
