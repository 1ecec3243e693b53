"""Wrapper of the min2 kernel (``csrc/min2.cu``), best-hit phase A.

CPU tensors take the plain version (``distance.min2_reference``); CUDA
tensors launch the kernel on the current stream, or raise. ``launches``
counts calls that launched the kernel (one per call, with or without
the merge of its db splits).
"""

from __future__ import annotations

import functools

import torch

from smafa_tpu_torch.ops import _build
from smafa_tpu_torch.ops import distance as D

launches = 0

# The short route (EP <= SPLIT_EP_MAX, L <= 64) of all four scans, the
# warp-specialised wgmma tile (csrc/wg_scan.cuh), which ``short_plan``
# mirrors: query rows a block, db rows a step, one persistent block an
# SM. An item's fixed cost in steps: its A fragments and the drain
# (compact_mask), and for min2 also the exact updates of its split,
# whose every row restarts its running best and meets again the records
# and ties of a running maximum (tools/torch_wg_probe.py --splits times
# the kernels at other splits; PERF.md section 6). kstats' and
# min_count's item costs (below) serve both their routes: on an H100 the
# short route's planned splits came within 0.4% of the best of those
# timed at their main shapes.
SPLIT_EP_MAX = 256
WG_ROUTE = "wgmma"
WG_ROWS = 256
WG_STEP = 64
MIN2_ITEM_STEPS = 32
COMPACT_ITEM_STEPS = 4


# The long routes (EP > SPLIT_EP_MAX) of all four scans, the K-chunked
# wgmma tile (csrc/wg_long.cuh), which ``long_plan`` mirrors: WG_ROWS
# query rows a block, form (a) ("wg_kchunk") with the rows resident up
# to WG_RESIDENT_EP_MAX (L <= 160) in db steps of WG_KCHUNK_STEP rows,
# form (b) ("wg_kchunk_stream") past it in steps of WG_STREAM_STEP rows;
# each kernel's item cost as on the short route. kstats' items restart
# nothing (its counts add, its minima merge), as compact_mask's; each of
# min_count's splits restarts its rows' running best, as min2's.
WG_KCHUNK_ROUTE = "wg_kchunk"
WG_STREAM_ROUTE = "wg_kchunk_stream"
WG_RESIDENT_EP_MAX = 640
WG_KCHUNK_STEP = 64
WG_STREAM_STEP = 128
KSTATS_ITEM_STEPS = 4
MIN_COUNT_ITEM_STEPS = 32


def splits_for(qtiles: int, steps: int, sms: int, item_steps: int) -> int:
    """db splits S of a persistent grid over qtiles x S items (min(items,
    sms) blocks): the least time in steps of the busiest block,
    ceil(qtiles S / sms) items of steps / S + item_steps steps each, over
    1 <= S <= min(steps, sms); the fewest splits on a tie (costs compared
    as fractions num / S, exactly)."""
    best, best_num = 1, None
    for s in range(1, min(steps, sms) + 1):
        num = -(-qtiles * s // sms) * (steps + item_steps * s)
        if best_num is None or num * best < best_num * s:
            best, best_num = s, num
    return best


@functools.lru_cache(maxsize=None)
def short_plan(b: int, wp: int, sms: int, item_steps: int) -> int:
    """db splits S of the short route's launch of min2 (item_steps
    MIN2_ITEM_STEPS), compact_mask (COMPACT_ITEM_STEPS), kstats or
    min_count (their item costs; wp their live rows, ``live_plan``) with
    b >= 1 query rows and wp db rows, a multiple of WG_STEP, on a card with
    ``sms`` SMs: items = ceil(b / WG_ROWS) query tiles x S db splits
    (``splits_for``; split i of S walks steps steps * i // S up to steps
    * (i + 1) // S), which the kernel walks with min(items, sms)
    persistent blocks. Cached: the search is host work every launch of a
    shape would repeat."""
    return splits_for(-(-b // WG_ROWS), wp // WG_STEP, sms, item_steps)


@functools.lru_cache(maxsize=None)
def long_plan(b: int, wp: int, ep: int, sms: int,
              item_steps: int) -> tuple[str, int]:
    """(route, db splits) of the long route's launch of min2,
    compact_mask, kstats or min_count (EP > SPLIT_EP_MAX; item_steps the
    kernel's, as in ``short_plan``; kstats' and min_count's wp their live
    rows, ``live_plan``):
    "wg_kchunk" up to WG_RESIDENT_EP_MAX with db steps of WG_KCHUNK_STEP
    rows, else "wg_kchunk_stream" with steps of WG_STREAM_STEP rows (the
    last may pass wp, a multiple of 64); ``splits_for`` over ceil(b /
    WG_ROWS) query tiles and the steps. Cached, as ``short_plan``."""
    if ep <= WG_RESIDENT_EP_MAX:
        route, step = WG_KCHUNK_ROUTE, WG_KCHUNK_STEP
    else:
        route, step = WG_STREAM_ROUTE, WG_STREAM_STEP
    return route, splits_for(-(-b // WG_ROWS), -(-wp // step), sms,
                             item_steps)


def scan_plan(b: int, wp: int, ep: int, sms: int,
              item_steps: int) -> tuple[str, int]:
    """(route, db splits) of a launch of one of the four scans
    (item_steps: the kernel's, see ``short_plan``): the short route
    (``WG_ROUTE``) up to SPLIT_EP_MAX, else ``long_plan``'s."""
    if ep <= SPLIT_EP_MAX:
        return WG_ROUTE, short_plan(b, wp, sms, item_steps)
    return long_plan(b, wp, ep, sms, item_steps)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of the card ``device`` names, queried once per device: the
    query is host work that every launch would otherwise repeat."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_plan(b: int, wp: int, ep: int, sms: int) -> tuple[str, int]:
    """(route, db splits) of a launch of the min2 wrapper."""
    return scan_plan(b, wp, ep, sms, MIN2_ITEM_STEPS)


def live_plan(b: int, n_valid: int, ep: int, sms: int,
              item_steps: int) -> tuple[str, int]:
    """(route, db splits) of a kstats or min_count call (item_steps:
    KSTATS_ITEM_STEPS or MIN_COUNT_ITEM_STEPS), which scan only the first
    ``n_valid`` db rows, on a card with ``sms`` SMs: ("none", 0) when
    there is nothing to scan (b == 0 or n_valid == 0), which launches
    nothing; else, over the live rows only, ceil(n_valid / 64) x 64 of
    them, so no split walks the buffer past n_valid's 64-row block:
    ``scan_plan``'s route and splits (the short route up to
    SPLIT_EP_MAX; past it form (a) up to 160 bp and form (b) past it)."""
    if b == 0 or n_valid == 0:
        return "none", 0
    live = -(-n_valid // D.WP_MULTIPLE) * D.WP_MULTIPLE
    return scan_plan(b, live, ep, sms, item_steps)


def check_operands(q_emb: torch.Tensor, db_emb: torch.Tensor,
                   zc: torch.Tensor, seq_len: int) -> None:
    """Raise on operands the kernels do not take (shared with compact)."""
    if not (q_emb.device == db_emb.device == zc.device):
        raise ValueError("operands must lie on one device")
    if q_emb.dtype != torch.int8 or db_emb.dtype != torch.int8:
        raise TypeError("q_emb and db_emb must be int8")
    if zc.dtype != torch.int32:
        raise TypeError("zc must be int32")
    if q_emb.ndim != 2 or db_emb.ndim != 2 or zc.ndim != 1:
        raise ValueError("q_emb, db_emb must be 2-D and zc 1-D")
    ep = D.embed_width(seq_len)
    if q_emb.shape[1] != ep or db_emb.shape[1] != ep:
        raise ValueError(f"embed width must be {ep} for seq_len {seq_len}")
    wp = db_emb.shape[0]
    if wp == 0 or wp % D.WP_MULTIPLE or zc.shape[0] != wp:
        raise ValueError(
            f"db rows ({wp}) must be a positive multiple of "
            f"{D.WP_MULTIPLE}, with one zc entry each")
    if not (q_emb.is_contiguous() and db_emb.is_contiguous()
            and zc.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if q_emb.is_cuda and (q_emb.data_ptr() % 16 or db_emb.data_ptr() % 16):
        raise ValueError("q_emb and db_emb must be 16-byte aligned")
    if q_emb.shape[0] >= 2**31 or wp >= 2**31:
        raise ValueError("operands exceed the kernels' int32 sizes")


def check_tma_zc(zc: torch.Tensor) -> None:
    """Raise unless zc may be a TMA source (16-byte aligned), as every
    route of the four scans copies it."""
    if zc.data_ptr() % 16:
        raise ValueError("zc must be 16-byte aligned (a TMA source)")


def min2(q_emb: torch.Tensor, db_emb: torch.Tensor, zc: torch.Tensor,
         seq_len: int, shift: int,
         with_count: bool = True) -> tuple[torch.Tensor, ...]:
    """(lo, hi[, cnt]) int32 [B]: see ``distance.min2_reference``."""
    global launches
    check_operands(q_emb, db_emb, zc, seq_len)
    wp = db_emb.shape[0]
    if wp > (1 << shift) or (seq_len + 1) << shift >= 2**31:
        raise ValueError(f"shift {shift} cannot pack {wp} rows at L={seq_len}")
    if q_emb.device.type == "cpu":
        return D.min2_reference(q_emb, db_emb, zc, seq_len, shift, with_count)
    if not q_emb.is_cuda:
        raise ValueError(f"no min2 kernel for device {q_emb.device}")
    b = q_emb.shape[0]
    lo = torch.empty((b,), dtype=torch.int32, device=q_emb.device)
    hi = torch.empty_like(lo)
    cnt = torch.empty_like(lo) if with_count else lo  # unused when off
    if b == 0:
        return (lo, hi, cnt) if with_count else (lo, hi)
    ep = q_emb.shape[1]
    check_tma_zc(zc)
    _, s = kernel_plan(b, wp, ep, sm_count(q_emb.device))
    # the splits' partials; the caching allocator ties it to this stream
    part = torch.empty((3, s, b), dtype=torch.int32,
                       device=q_emb.device) if s > 1 else None
    lib = _build.load()
    stream = torch.cuda.current_stream(q_emb.device).cuda_stream
    rc = lib.smafa_min2(q_emb.data_ptr(), db_emb.data_ptr(), zc.data_ptr(),
                        lo.data_ptr(), hi.data_ptr(), cnt.data_ptr(),
                        None if part is None else part.data_ptr(), b, wp, ep,
                        seq_len, shift, int(with_count), s, stream)
    _build.check(rc, "min2")
    launches += 1
    return (lo, hi, cnt) if with_count else (lo, hi)
