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

import functools
from typing import NamedTuple

import torch

from smafa_tpu_torch.ops import _build
from smafa_tpu_torch.ops import distance as D
from smafa_tpu_torch.ops import min2 as M
from smafa_tpu_torch.ops.keys import HIST_MAX

launches = 0


class Route(NamedTuple):
    """One of the kernel's routes (csrc/hist.cu ``Route``)."""
    name: str
    ep_max: int | None  # the widest EP it takes (None: any)
    rows: int           # query rows a block
    step: int           # db rows a step
    copies: int         # copies of a row's 16-bit bins: 4 (a lane's
    #                     own) or 2 (a lane pair's), [d][8 copies] words
    #                     a warp, a word's halves rows g and g + 8; 0: one
    #                     copy a row, two bins a word
    rows_at: str        # where the query rows live an item: "registers"
    #                     (A fragments, EP <= 256), "shared" (resident),
    #                     "streamed" (K chunks beside the db's)


# By embedding width; one block an SM on every route; every warpgroup's
# wgmma is m64 x N. "kchunk" takes EP up to RESIDENT_EP_MAX (L <= 168,
# csrc/hist.cu smafa_hist): the widest whose query rows and ring fit.
RESIDENT_EP_MAX = 672
ROUTES = (Route("split", M.SPLIT_EP_MAX, 128, 128, 4, "registers"),
          Route("kchunk", RESIDENT_EP_MAX, 128, 128, 2, "shared"),
          Route("kchunk_stream", None, 64, 256, 0, "streamed"))
N = 128  # db columns of a warpgroup's wgmma

# csrc/hist.cu's shared-memory plan
SMEM_LIMIT = 232_448    # shared bytes a block can use
CONSUMER_WARPS = 8      # two consumer warpgroups (and a producer one)
RING_MAX = 6            # stages of the TMA ring at most
ZC_STEPS = 4            # steps' zc in flight
PANEL = 128             # bytes of a row a TMA box (the 128-byte swizzle)
SLACK, BAR_BYTES = 1024, 256
# an item's fixed cost (its query rows, its flush), in steps of its route
ITEM_STEPS = 4


class Plan(NamedTuple):
    route: str
    splits: int
    block_rows: int   # query rows a block
    bin_bytes: int    # shared bytes of a block's bins
    stages: int       # stages of the TMA ring
    smem_bytes: int   # dynamic shared bytes of a block
    flush_steps: int  # steps between flushes of the 16-bit bins
    grid: int         # persistent blocks: min(items, SMs)


def route_of(seq_len: int) -> Route:
    ep = D.embed_width(seq_len)
    return next(r for r in ROUTES if r.ep_max is None or ep <= r.ep_max)


def _panels(ep: int) -> int:
    return -(-ep // PANEL)


def bin_bytes(r: Route, seq_len: int) -> int:
    if r.copies:
        return CONSUMER_WARPS * (seq_len + 1) * 8 * r.copies * 4
    return r.rows * (((seq_len + 2) // 2) | 1) * 4  # an odd row stride


def stage_bytes(r: Route) -> int:
    """A ring stage: a db K chunk of 128 bytes, and the query K chunk
    beside it when streamed."""
    return ((r.rows if r.rows_at == "streamed" else 0) + r.step) * PANEL


def fixed_bytes(r: Route, seq_len: int, ep: int) -> int:
    """Shared bytes beside the ring: resident query rows, the zc ring,
    the bins, the barriers, the alignment slack."""
    return ((_panels(ep) * r.rows * PANEL if r.rows_at == "shared" else 0)
            + ZC_STEPS * r.step * 4 + bin_bytes(r, seq_len) + BAR_BYTES
            + SLACK)


def increments_per_step(r: Route) -> int:
    """The most one 16-bit bin takes a step: N / copies columns of a row
    (the lanes sharing a copy), or every column of the step."""
    return N // r.copies if r.copies else r.step


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, n_valid: int, seq_len: int, sms: int) -> Plan:
    """The hist kernel's launch on a card with ``sms`` SMs: its route by
    the embedding width, its ring and shared bytes, and db splits S:
    items = ceil(b / rows a block) query tiles x S, walked by min(items,
    sms) persistent blocks (``min2.splits_for``). ("none", 0, ...) when
    there is nothing to scan (b == 0 or n_valid == 0), which launches
    nothing. Cached: the search is host work every launch of a shape
    would repeat."""
    ep = D.embed_width(seq_len)
    r = route_of(seq_len)
    stage, fixed = stage_bytes(r), fixed_bytes(r, seq_len, ep)
    stages = min(RING_MAX, (SMEM_LIMIT - fixed) // stage)
    flush = 65535 // increments_per_step(r)
    args = (r.rows, bin_bytes(r, seq_len), stages, fixed + stages * stage,
            flush)
    if b == 0 or n_valid == 0:
        return Plan("none", 0, *args, 0)
    qtiles, steps = -(-b // r.rows), -(-n_valid // r.step)
    splits = M.splits_for(qtiles, steps, sms, ITEM_STEPS)
    return Plan(r.name, splits, *args, min(qtiles * splits, sms))


def work_items(plan: Plan, b: int, n_valid: int) -> list[tuple[int, ...]]:
    """The kernel's items in order, as (block, first query row, end
    query row, first db row, end db row): item i is query tile i %
    qtiles against db split i // qtiles (steps [T y / S, T (y + 1) / S)
    of T), run by block i % grid."""
    r = next(x for x in ROUTES if x.name == plan.route)
    qtiles, steps = -(-b // r.rows), -(-n_valid // r.step)
    out = []
    for i in range(qtiles * plan.splits):
        qt, y = i % qtiles, i // qtiles
        s0, s1 = steps * y // plan.splits, steps * (y + 1) // plan.splits
        out.append((i % plan.grid, qt * r.rows, min(b, (qt + 1) * r.rows),
                    s0 * r.step, min(n_valid, s1 * r.step)))
    return out


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
    if zc.data_ptr() % 16:
        raise ValueError("zc must be 16-byte aligned (a TMA source)")
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
