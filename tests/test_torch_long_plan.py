"""The launch plan past 64 bp, on the CPU: which route and how many db
splits each kernel gets, and the constants the plan mirrors from the
CUDA sources.

``ops/min2.py``'s ``live_plan`` is kstats' and min_count's plan. Up to
EP = 256 bytes (L <= 64) they take the wgmma tile of csrc/wg_scan.cuh
(``short_plan`` over the live rows); past it the K-chunked wgmma tile
of csrc/wg_long.cuh, as min2 and compact_mask do (``long_plan``, over
the live rows, each kernel's own item cost): "wg_kchunk", query rows
resident, up to EP = 640 (160 bp), and "wg_kchunk_stream" past it. min2
and compact_mask take ``kernel_plan``: ``short_plan`` up to 64 bp
(tests/test_torch_wg_plan.py), ``long_plan`` past it
(tests/test_torch_wg_long_plan.py).

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import inspect
import pathlib
import re
import types

import pytest

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE
H100_SMS = 132
SMEM_MAX = 232448  # bytes of shared memory a block can use on an H100
CSRC = pathlib.Path(__file__).resolve().parent.parent / "smafa_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import compact, distance, kstats, min2, min_count

    return types.SimpleNamespace(torch=torch, C=compact, D=distance,
                                 KS=kstats, M=min2, MC=min_count)


def _constants(name: str) -> dict[str, int]:
    """The ``constexpr int NAME = <integer>;`` lines of a source."""
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _plans(port, b, rows, ep):
    """(route, splits) of each kernel at b reads x rows (rows live, a
    multiple of 64 for min2 and compact_mask)."""
    M = port.M
    return {"min2": M.kernel_plan(b, rows, ep, H100_SMS),
            "kstats": M.live_plan(b, rows, ep, H100_SMS, M.KSTATS_ITEM_STEPS),
            "compact_mask": port.C.kernel_plan(b, rows, ep, H100_SMS),
            "min_count": M.live_plan(b, rows, ep, H100_SMS,
                                     M.MIN_COUNT_ITEM_STEPS)}


def _item_steps(M):
    return {"min2": M.MIN2_ITEM_STEPS, "compact_mask": M.COMPACT_ITEM_STEPS,
            "kstats": M.KSTATS_ITEM_STEPS,
            "min_count": M.MIN_COUNT_ITEM_STEPS}


@pytest.mark.parametrize("ep,want", [(256, "wgmma"), (288, "wg_kchunk"),
                                     (640, "wg_kchunk"),
                                     (672, "wg_kchunk_stream"),
                                     (704, "wg_kchunk_stream"),
                                     (119616, "wg_kchunk_stream")])
def test_routes_at_the_boundaries(port, ep, want):
    """EP 256 (64 bp), 288 (the first long width, 65-72 bp), 640 (160
    bp, form (a)'s last), 672 (161-168 bp, which the K-chunked split tile
    took in form (a)), 704 and 119,616 (29,903 bp): past 64 bp all four
    kernels take ``long_plan``'s route and splits, each with its own
    item cost; at 64 bp all four the short wgmma route, with
    ``short_plan``'s splits at their item costs."""
    M = port.M
    steps = _item_steps(M)
    for b, rows in ((1, 64), (77, 32768), (1024, 32768), (4096, 2621440),
                    (32768, 2621440), (65536, 64)):
        plans = _plans(port, b, rows, ep)
        tiles = rows // WP_MULTIPLE
        for kernel, (route, s) in plans.items():
            if ep > M.SPLIT_EP_MAX:
                assert route == want, kernel
                assert (route, s) == M.long_plan(b, rows, ep, H100_SMS,
                                                 steps[kernel])
            else:
                assert route == want == M.WG_ROUTE, kernel
                assert s == M.short_plan(b, rows, H100_SMS, steps[kernel])
            assert 1 <= s <= tiles


def test_chunk_splits_fill_one_wave_and_never_exceed_the_live_tiles(port):
    """Past 64 bp kstats' and min_count's splits are ``long_plan``'s over
    the live rows (ceil(n_valid / 64) x 64): never more than the live
    steps (64 rows in form (a), 128 in form (b)) nor the SMs; the phase
    9, 10 (b) and 12 (b) shapes get the splits named. Nothing is planned
    at B = 0 or n_valid = 0."""
    M = port.M
    for ep in (288, 608, 640, 672, 1216, 119616):
        step = M.WG_KCHUNK_STEP if ep <= M.WG_RESIDENT_EP_MAX else M.WG_STREAM_STEP
        for b in (1, 77, 256, 1024, 4096, 32768, 33792, 1 << 20):
            for n_valid in (1, 37, 64, 65, 3001, 32768, 2621440):
                live = -(-n_valid // WP_MULTIPLE) * WP_MULTIPLE
                for kernel in ("kstats", "min_count"):
                    item = _item_steps(M)[kernel]
                    route, s = M.live_plan(b, n_valid, ep, H100_SMS, item)
                    assert (route, s) == M.long_plan(b, live, ep, H100_SMS,
                                                     item)
                    assert 1 <= s <= min(-(-live // step), H100_SMS)
    K, MC = M.KSTATS_ITEM_STEPS, M.MIN_COUNT_ITEM_STEPS
    assert M.live_plan(4096, 2621440, 608, H100_SMS, K) == ("wg_kchunk", 33)
    assert M.live_plan(1024, 32768, 1216, H100_SMS, K) == (
        "wg_kchunk_stream", 33)
    assert M.live_plan(1024, 32768, 119616, H100_SMS, K) == (
        "wg_kchunk_stream", 33)
    assert M.live_plan(32768, 1 << 22, 1216, H100_SMS, MC) == (
        "wg_kchunk_stream", 33)
    assert M.live_plan(32768, 32768, 608, H100_SMS, MC) == ("wg_kchunk", 1)
    for item in (K, MC):
        assert M.live_plan(0, 32768, 608, H100_SMS, item) == ("none", 0)
        assert M.live_plan(77, 0, 608, H100_SMS, item) == ("none", 0)


def test_mirrored_constants_equal_the_sources(port):
    """ops/min2.py's SPLIT_EP_MAX is wg_scan.cuh's widest row (two
    panels of PANEL bytes), and ops/hist.py's RESIDENT_EP_MAX is
    hist.cu's "kchunk" limit; kstats.cu and min_count.cu run wg_scan.cuh
    up to its EP_MAX and wg_long.cuh past it, through its one choice of
    form; the split tile (split_tile.cuh, its planners BM,
    BLOCKS_PER_SM, split_count and launch_plan) and the K-chunked split
    tile are gone (no kchunk_scan, no chunk kernel, no K_CHUNK); no
    first-version loop is left (scan_tile.cuh is gone)."""
    M = port.M
    assert M.SPLIT_EP_MAX == 2 * _constants("wg_tile.cuh")["PANEL"]
    assert not (CSRC / "split_tile.cuh").exists()
    for gone in ("BM", "BLOCKS_PER_SM", "split_count", "launch_plan"):
        assert not hasattr(M, gone), gone
    from smafa_tpu_torch.ops import hist

    assert f"EP > {hist.RESIDENT_EP_MAX} ? 0 : panels(EP)" in (
        CSRC / "hist.cu").read_text()
    assert not hasattr(M, "RESIDENT_EP_MAX")
    assert not hasattr(M, "CHUNK_BLOCKS_PER_SM")
    for src in ("min2.cu", "kstats.cu", "compact.cu", "min_count.cu"):
        text = (CSRC / src).read_text()
        assert "S_KS" not in text and '#include "split_tile.cuh"' not in text
        assert "EP <= wg_scan::EP_MAX" in text
        assert '#include "wg_long.cuh"' in text
        assert "wg_long::by_form(EP," in text
        assert "kchunk_scan" not in text and "_chunk_kernel" not in text
        assert "launch_long" not in text and "scan_tile" not in text
    assert "min2_long_kernel" not in (CSRC / "min2.cu").read_text()
    assert "kstats_kernel(" not in (CSRC / "kstats.cu").read_text()
    assert "compact_long_kernel" not in (CSRC / "compact.cu").read_text()
    assert "min_count_kernel" not in (CSRC / "min_count.cu").read_text()
    assert not (CSRC / "scan_tile.cuh").exists()


def _form_a_smem(c, nkp):
    fixed = (nkp * c["ROWS"] * c["PANEL"] + c["ZS"] * c["NA"] * 4
             + c["BAR_BYTES"] + c["SLACK"])
    ring = min(c["RING_A"], (c["SMEM_LIMIT"] - fixed) // (c["NA"] * c["PANEL"]))
    return ring, fixed + ring * c["NA"] * c["PANEL"]


def test_form_a_limit_is_the_widest_that_fits(port):
    """kstats' and min_count's long routes launch through wg_long.cuh's
    ``launch``, whose shared memory fits 232,448 bytes: form (a) at
    every panel count up to NKP_MAX (640 bytes, 160 bp) holds the
    resident rows and a ring of at least a step's chunks, and one panel
    more (168 bp's 672 bytes) would not; form (b) fits at any width.
    Their wgchunk kernels are built for each of by_form's forms."""
    c = {**_constants("wg_tile.cuh"), **_constants("wg_long.cuh")}
    assert c["SMEM_LIMIT"] == SMEM_MAX
    for nkp in range(3, c["NKP_MAX"] + 1):
        ring, smem = _form_a_smem(c, nkp)
        assert nkp <= ring and smem <= SMEM_MAX
    assert _form_a_smem(c, c["NKP_MAX"] + 1)[0] < c["NKP_MAX"] + 1
    assert port.M.WG_RESIDENT_EP_MAX == c["NKP_MAX"] * c["PANEL"] == 640
    assert port.D.embed_width(160) == 640 < port.D.embed_width(161) == 672
    smem_b = (c["RING_B"] * (c["ROWS"] + c["NB"]) * c["PANEL"]
              + c["ZS"] * c["NB"] * 4 + c["BAR_BYTES"] + c["SLACK"])
    assert smem_b <= SMEM_MAX
    for src, kernel in (("kstats.cu", "kstats_wgchunk_kernel<NKP>"),
                        ("min_count.cu",
                         "min_count_wgchunk_kernel<NKP, WITH_COUNT>")):
        text = (CSRC / src).read_text()
        assert "wg_long::launch<NKP>(" in text and kernel in text, src
        assert "__launch_bounds__(wg_long::THREADS, 1)" in text, src


def test_wrappers_plan_by_kernel(port):
    """Every wrapper asks for the one plan (no per-kernel argument), and
    no C entry refuses more than one split past 64 bp: each checks only
    1 <= splits <= the (live) 64-row tiles."""
    src = {m: inspect.getsource(f) for m, f in (
        ("min2", port.M.min2), ("kstats", port.KS.kstats),
        ("compact_mask", port.C.compact_mask), ("min_count", port.MC.min_count))}
    assert "chunked" not in "".join(src.values())
    assert "chunked" not in inspect.signature(port.M.scan_plan).parameters
    assert "chunked" not in inspect.signature(port.M.live_plan).parameters
    for name in ("min2.cu", "kstats.cu", "compact.cu", "min_count.cu"):
        text = (CSRC / name).read_text()
        assert "splits != 1" not in text, name
        assert re.search(r"splits < 1 \|\| splits > ", text), name


def _live_items(M, b, n_valid, ep, item_steps, sms, splits=None):
    """kstats' or min_count's items past 64 bp as csrc/wg_long.cuh walks
    them over the live rows: (query tile, split, the 64-row blocks its
    steps hold below the live rows), and the route and splits (the
    plan's, or ``splits``)."""
    route, planned = M.live_plan(b, n_valid, ep, sms, item_steps)
    splits = splits or planned
    live = -(-n_valid // WP_MULTIPLE)  # live 64-row blocks
    per = 1 if route == M.WG_KCHUNK_ROUTE else M.WG_STREAM_STEP // WP_MULTIPLE
    steps = -(-live // per)
    items = []
    for qt in range(-(-b // M.WG_ROWS)):
        for y in range(splits):
            s0, s1 = steps * y // splits, steps * (y + 1) // splits
            items.append((qt, y, [blk for s in range(s0, s1)
                                  for blk in range(per * s, per * s + per)
                                  if blk < live]))
    return route, splits, live, items


@pytest.mark.parametrize("n_valid", [1, 64, 65, 127, 128, 129, 3001,
                                     4096 + 64 + 1])
def test_live_items_cover_each_live_block_once(port, n_valid):
    """n_valid ragged against the 64-row block and the 128-row stream
    step, in both forms (150 and 300 bp) and for both kernels, at the
    plan's splits and at 7 and ceil(n_valid / 64) splits (the C entry's
    widest): each query tile's items hold every live block exactly once
    and none past them (form (b)'s last step may hold one live block,
    whose other half the kernel skips); the last live block, partial
    unless 64 divides n_valid, has one owner; and the plan's splits are
    never more than the live steps."""
    M = port.M
    for ep in (608, 1216):
        for kernel, item in (("kstats", M.KSTATS_ITEM_STEPS),
                             ("min_count", M.MIN_COUNT_ITEM_STEPS)):
            live = -(-n_valid // WP_MULTIPLE)
            for b, splits in ((1, None), (300, None), (300, min(7, live)),
                              (1, live)):
                route, s, _, items = _live_items(M, b, n_valid, ep, item,
                                                 H100_SMS, splits)
                per = 1 if route == M.WG_KCHUNK_ROUTE else 2
                assert route == ("wg_kchunk" if ep <= 640
                                 else "wg_kchunk_stream")
                if splits is None:
                    assert 1 <= s <= -(-live // per)
                for qt in range(-(-b // M.WG_ROWS)):
                    blocks = sorted(x for q, _, bl in items if q == qt
                                    for x in bl)
                    assert blocks == list(range(live)), (kernel, ep, b)
                    owners = [y for q, y, bl in items
                              if q == qt and live - 1 in bl]
                    assert len(owners) == 1


def test_pair_counts_flush_by_blocks(port):
    """kstats' epilogue counts in 16-bit pairs (in byte lanes first below
    64 bp): a lane adds at most 16 to a count a 64-row block, so
    PAIR_TILES blocks stay below 65,536, and the epilogue flushes by
    blocks (form (b)'s steps are two), at each item's end too; its
    masked path runs only at the last live block."""
    c = _constants("kstats.cu")
    assert 16 * c["PAIR_TILES"] < 1 << 16 <= 16 * (c["PAIR_TILES"] + 1)
    text = (CSRC / "kstats.cu").read_text()
    assert "if (M == 1 && ++blocks == PAIR_TILES)" in text
    assert "end(const wg_scan::Item&) { flush(true); }" in text
    for src in ("kstats.cu", "min_count.cu"):
        text = (CSRC / src).read_text()
        assert "last = rem < wg_scan::N ? live - 1 : -1;" in text
        assert "if (s == last) {" in text


def test_long_routes_check_zc_as_a_tma_source(port):
    """On every route kstats and min_count copy zc by TMA: both wrappers
    check its alignment whatever the width (no branch on EP before the
    check), after planning (so n_valid = 0 launches nothing and checks
    nothing)."""
    for fn in (port.KS.kstats, port.MC.min_count):
        src = inspect.getsource(fn)
        assert "\n    M.check_tma_zc(zc)\n" in src
        assert "SPLIT_EP_MAX" not in src
        assert src.index("M.live_plan(") < src.index("M.check_tma_zc(zc)")
