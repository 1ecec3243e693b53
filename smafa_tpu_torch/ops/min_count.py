"""Wrapper of the min_count kernel (``csrc/min_count.cu``), the cluster
op's centroid scan.

CPU tensors take the plain version (``distance.min_count_reference``);
CUDA tensors launch the kernel on the current stream, or raise.
``launches`` counts calls that launched the kernel (one per call, with
or without the merge of its db splits; none when there is nothing to
scan).
"""

from __future__ import annotations

import torch

from smafa_tpu_torch.ops import _build
from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import min2 as M

launches = 0


def min_count(q_emb: torch.Tensor, db_emb: torch.Tensor, zc: torch.Tensor,
              n_valid: int, seq_len: int, shift: int,
              with_count: bool = True) -> tuple[torch.Tensor, ...]:
    """(key[, cnt]) int32 [B] over db rows < n_valid: see
    ``distance.min_count_reference``."""
    global launches
    M.check_operands(q_emb, db_emb, zc, seq_len)
    wp = db_emb.shape[0]
    if seq_len < 1:
        raise ValueError("seq_len must be positive")
    if not 0 <= n_valid <= wp:
        raise ValueError(f"n_valid ({n_valid}) must lie in [0, {wp}]")
    if wp > (1 << shift) or (seq_len + 1) << shift >= 2**31:
        raise ValueError(f"shift {shift} cannot pack {wp} rows at L={seq_len}")
    if q_emb.device.type == "cpu":
        return D.min_count_reference(q_emb, db_emb, zc, n_valid, seq_len,
                                     shift, with_count)
    if not q_emb.is_cuda:
        raise ValueError(f"no min_count kernel for device {q_emb.device}")
    b, ep = q_emb.shape
    _, s = M.live_plan(b, n_valid, ep, M.sm_count(q_emb.device),
                       M.MIN_COUNT_ITEM_STEPS)
    if s == 0:
        key = torch.full((b,), D.BIG_KEY, dtype=torch.int32,
                         device=q_emb.device)
        return (key, torch.zeros_like(key)) if with_count else (key,)
    key = torch.empty((b,), dtype=torch.int32, device=q_emb.device)
    cnt = torch.empty_like(key) if with_count else None
    # the splits' partials; the caching allocator ties it to this stream
    part = torch.empty((2 if with_count else 1, s, b), dtype=torch.int32,
                       device=q_emb.device) if s > 1 else None
    M.check_tma_zc(zc)
    lib = _build.load()
    stream = torch.cuda.current_stream(q_emb.device).cuda_stream
    rc = lib.smafa_min_count(q_emb.data_ptr(), db_emb.data_ptr(),
                             zc.data_ptr(), key.data_ptr(),
                             None if cnt is None else cnt.data_ptr(),
                             None if part is None else part.data_ptr(), b,
                             n_valid, ep, seq_len, shift, int(with_count), s,
                             stream)
    _build.check(rc, "min_count")
    launches += 1
    return (key, cnt) if with_count else (key,)
