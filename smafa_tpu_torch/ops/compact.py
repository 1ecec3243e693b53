"""Wrapper of the compact_mask kernel (``csrc/compact.cu``), the hit
bitmask of best-hit tie enumeration and K-mode.

CPU tensors take the plain version (``distance.compact_mask_reference``);
CUDA tensors launch the kernel on the current stream, or raise.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from smafa_tpu_torch.ops import _build
from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops.min2 import (COMPACT_ITEM_STEPS, check_operands,
                                      check_tma_zc, scan_plan, sm_count)

launches = 0


def kernel_plan(b: int, wp: int, ep: int, sms: int) -> tuple[str, int]:
    """(route, db splits) of a launch of the compact_mask wrapper."""
    return scan_plan(b, wp, ep, sms, COMPACT_ITEM_STEPS)


def compact_mask(q_emb: torch.Tensor, db_emb: torch.Tensor,
                 zc: torch.Tensor, thresh: torch.Tensor,
                 seq_len: int) -> torch.Tensor:
    """int32 [B, Wp/32] hit mask: see ``distance.compact_mask_reference``."""
    global launches
    check_operands(q_emb, db_emb, zc, seq_len)
    b, wp = q_emb.shape[0], db_emb.shape[0]
    if (thresh.dtype != torch.int32 or thresh.shape != (b,)
            or thresh.device != q_emb.device or not thresh.is_contiguous()):
        raise ValueError("thresh must be a contiguous int32 [B] tensor "
                         "on the operands' device")
    if q_emb.device.type == "cpu":
        return D.compact_mask_reference(q_emb, db_emb, zc, thresh, seq_len)
    if not q_emb.is_cuda:
        raise ValueError(f"no compact_mask kernel for device {q_emb.device}")
    mask = torch.empty((b, wp // 32), dtype=torch.int32, device=q_emb.device)
    if b == 0:
        return mask
    ep = q_emb.shape[1]
    check_tma_zc(zc)
    _, splits = kernel_plan(b, wp, ep, sm_count(q_emb.device))
    lib = _build.load()
    stream = torch.cuda.current_stream(q_emb.device).cuda_stream
    rc = lib.smafa_compact_mask(q_emb.data_ptr(), db_emb.data_ptr(),
                                zc.data_ptr(), thresh.data_ptr(),
                                mask.data_ptr(), b, wp, ep, seq_len, splits,
                                stream)
    _build.check(rc, "compact_mask")
    launches += 1
    return mask
