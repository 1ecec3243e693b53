"""Wrapper of the kstats kernel (``csrc/kstats.cu``), one pass of the
K-mode cutoff search.

CPU tensors take the plain version (``distance.stats_reference``); CUDA
tensors launch the kernel on the current stream, or raise. ``launches``
counts calls that launched the kernel (one per call, with or without the
merge of its db splits; none when there is nothing to scan).
"""

from __future__ import annotations

import torch

from smafa_tpu_torch.ops import _build
from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import min2 as M
from smafa_tpu_torch.ops.keys import KSTATS_PROBES

launches = 0


def kstats(q_emb: torch.Tensor, db_emb: torch.Tensor, zc: torch.Tensor,
           ts: torch.Tensor, n_valid: int,
           seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cnt int32 [P, B], mx int32 [B]) over db rows < n_valid at the
    per-row thresholds ts int32 [P, B], P = KSTATS_PROBES: see
    ``distance.stats_reference``.

    The operands must be the port's embeddings (``distance.embed_db`` and
    ``distance.expand_embed_query``), which ``check_operands`` checks by
    shape and type only: the kernel relies on their range. Below 64 bp it
    counts in byte lanes, which holds only while every score q . db + zc
    of a row below n_valid lies in [0, 63]; a score outside it would
    corrupt the counts silently. These embeddings give scores in [0, L]
    to real windows and -1 to padding rows, which lie at or past
    n_valid."""
    global launches
    M.check_operands(q_emb, db_emb, zc, seq_len)
    b, wp = q_emb.shape[0], db_emb.shape[0]
    if (ts.dtype != torch.int32 or tuple(ts.shape) != (KSTATS_PROBES, b)
            or ts.device != q_emb.device or not ts.is_contiguous()):
        raise ValueError(f"ts must be a contiguous int32 [{KSTATS_PROBES}, B] "
                         "tensor on the operands' device")
    if not 0 <= n_valid <= wp:
        raise ValueError(f"n_valid ({n_valid}) must lie in [0, {wp}]")
    if q_emb.device.type == "cpu":
        return D.stats_reference(q_emb, db_emb, zc, ts, n_valid, seq_len)
    if not q_emb.is_cuda:
        raise ValueError(f"no kstats kernel for device {q_emb.device}")
    ep = q_emb.shape[1]
    _, s = M.live_plan(b, n_valid, ep, M.sm_count(q_emb.device),
                       M.KSTATS_ITEM_STEPS)
    if s == 0:
        return (torch.zeros((KSTATS_PROBES, b), dtype=torch.int32,
                            device=q_emb.device),
                torch.full((b,), -1, dtype=torch.int32, device=q_emb.device))
    cnt = torch.empty((KSTATS_PROBES, b), dtype=torch.int32,
                      device=q_emb.device)
    mx = torch.empty((b,), dtype=torch.int32, device=q_emb.device)
    # the splits' partials; the caching allocator ties it to this stream
    part = torch.empty((KSTATS_PROBES + 1, s, b), dtype=torch.int32,
                       device=q_emb.device) if s > 1 else None
    M.check_tma_zc(zc)
    lib = _build.load()
    stream = torch.cuda.current_stream(q_emb.device).cuda_stream
    rc = lib.smafa_kstats(q_emb.data_ptr(), db_emb.data_ptr(), zc.data_ptr(),
                          ts.data_ptr(), cnt.data_ptr(), mx.data_ptr(),
                          None if part is None else part.data_ptr(), b,
                          n_valid, ep, seq_len, s, stream)
    _build.check(rc, "kstats")
    launches += 1
    return cnt, mx
