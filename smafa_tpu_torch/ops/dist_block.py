"""Wrapper of the dist_block kernel (``csrc/dist_block.cu``), the exact
int32 distance block of the wide route (``parallel.wide``, and the
cluster's wide centroid scan).

CPU tensors take the plain version (``distance.dist_block_reference``);
CUDA tensors launch the kernel on the current stream, or raise.
``launches`` counts calls that launched it (one a call: the block's
init and its split-K product).
"""

from __future__ import annotations

import torch

from smafa_tpu_torch.ops import _build
from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import min2 as M

launches = 0

# The kernel's tile (csrc/dist_block.cu): query rows and db rows a block,
# bytes of a row a K chunk, resident blocks an SM; the plan asks for
# WAVES waves of blocks over the card.
BM = 64
BN = 64
KC = 128
BLOCKS_PER_SM = 3
WAVES = 4
GRID_MAX = 65535  # the grid's y (splits) and z (query tiles)
# The widest embedding the kernel's int EP holds (windows below 2^29 bp).
MAX_EP = 2**31 - D.K_STEP


def split_k(b: int, wp: int, ep: int, sms: int) -> int:
    """K splits S of a launch on a card with ``sms`` SMs: enough blocks
    (ceil(b / 64) query tiles x wp / 64 db tiles x S) for WAVES waves of
    the card's resident blocks, never more than the K chunks of ceil(ep
    / KC) nor GRID_MAX."""
    tiles = -(-b // BM) * (wp // BN)
    want = -(-(sms * BLOCKS_PER_SM * WAVES) // tiles)
    return max(1, min(-(-ep // KC), GRID_MAX, want))


def dist_block(q_emb: torch.Tensor, db_emb: torch.Tensor, zc: torch.Tensor,
               seq_len: int) -> torch.Tensor:
    """int32 [B, Wp] exact distances: see ``distance.dist_block_reference``."""
    global launches
    M.check_operands(q_emb, db_emb, zc, seq_len)
    b, ep = q_emb.shape
    wp = db_emb.shape[0]
    if ep > MAX_EP:
        raise ValueError(
            f"embed width {ep} bytes passes dist_block's limit of {MAX_EP} "
            f"bytes (an int32 EP: windows of at most {MAX_EP // 4} bp)")
    if -(-b // BM) > GRID_MAX:
        raise ValueError(f"{b} query rows pass dist_block's "
                         f"{GRID_MAX * BM}-row grid")
    if q_emb.device.type == "cpu":
        return D.dist_block_reference(q_emb, db_emb, zc, seq_len)
    if not q_emb.is_cuda:
        raise ValueError(f"no dist_block kernel for device {q_emb.device}")
    out = torch.empty((b, wp), dtype=torch.int32, device=q_emb.device)
    if b == 0:
        return out
    s = split_k(b, wp, ep, M.sm_count(q_emb.device))
    lib = _build.load()
    stream = torch.cuda.current_stream(q_emb.device).cuda_stream
    rc = lib.smafa_dist_block(q_emb.data_ptr(), db_emb.data_ptr(),
                              zc.data_ptr(), out.data_ptr(), b, wp, ep,
                              seq_len, s, stream)
    _build.check(rc, "dist_block")
    launches += 1
    return out
