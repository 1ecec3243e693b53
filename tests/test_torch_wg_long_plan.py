"""The long routes' launch plan of min2 and compact_mask
(``ops/min2.py:long_plan``, the K-chunked wgmma tile of
csrc/wg_long.cuh), on the CPU: the route by width at each boundary,
every (query tile, db step) pair covered once by the persistent items,
the grid within the SMs, the splits at the main shapes, each form's
shared memory at its widest row, and the constants the plan mirrors
from the sources.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import pathlib
import re
import types

import numpy as np
import pytest

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE
H100_SMS = 132
SMEM_MAX = 232448  # bytes of shared memory a block can use on an H100
CSRC = pathlib.Path(__file__).resolve().parent.parent / "smafa_tpu_torch" / "csrc"
BATCHES = (1, 77, 4096, 32768)


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import compact, distance, min2

    return types.SimpleNamespace(torch=torch, C=compact, D=distance, M=min2)


def _constants(name: str) -> dict[str, int]:
    """The ``constexpr int NAME = <integer>;`` lines of a source."""
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _plans(port, b, wp, ep):
    return {"min2": port.M.kernel_plan(b, wp, ep, H100_SMS),
            "compact_mask": port.C.kernel_plan(b, wp, ep, H100_SMS)}


@pytest.mark.parametrize("ep,want", [
    (256, "wgmma"), (288, "wg_kchunk"), (640, "wg_kchunk"),
    (672, "wg_kchunk_stream"), (1216, "wg_kchunk_stream"),
    (119616, "wg_kchunk_stream")])
def test_routes_at_the_boundaries(port, ep, want):
    """EP 256 (64 bp: the short route), 288 (65 bp, the first long
    width), 640 (160 bp, form (a)'s widest), 672 (the next, 161-168 bp),
    1,216 (300 bp) and 119,616 (29,903 bp): both kernels take the route
    named, at every batch; past 64 bp with ``long_plan``'s splits, each
    kernel's own item cost."""
    M = port.M
    steps = {"min2": M.MIN2_ITEM_STEPS, "compact_mask": M.COMPACT_ITEM_STEPS}
    for b in BATCHES:
        for wp in (64, 32768, 2621440):
            for kernel, (route, s) in _plans(port, b, wp, ep).items():
                assert route == want, (kernel, b, wp)
                if ep > M.SPLIT_EP_MAX:
                    assert (route, s) == M.long_plan(b, wp, ep, H100_SMS,
                                                     steps[kernel])
                    step = (M.WG_KCHUNK_STEP if route == M.WG_KCHUNK_ROUTE
                            else M.WG_STREAM_STEP)
                    assert 1 <= s <= -(-wp // step) <= wp // WP_MULTIPLE


def _items(M, b: int, wp: int, ep: int, item_steps: int, sms: int):
    """The kernel's items in its order (item it, run by block it % grid:
    query tile it % qtiles against split it // qtiles, or in form (b)
    split it % S of query tile it // S, as csrc/wg_long.cuh
    split_fastest_b picks it: with every item in the grid where S <= 2 x
    the query tiles, with more items than the grid where the query rows
    of the tiles in flight pass its L2_QUERY_MB), as (block, first
    query row, end query row, first db row, end db row)."""
    route, splits = M.long_plan(b, wp, ep, sms, item_steps)
    step = M.WG_KCHUNK_STEP if route == M.WG_KCHUNK_ROUTE else M.WG_STREAM_STEP
    qtiles, steps = -(-b // M.WG_ROWS), -(-wp // step)
    grid = min(qtiles * splits, sms)  # csrc/wg_long.cuh launch
    if qtiles * splits <= grid:
        split_fastest = splits <= 2 * qtiles
    else:
        split_fastest = (min(qtiles, grid) * M.WG_ROWS * -(-ep // 128) * 128
                         > _constants("wg_long.cuh")["L2_QUERY_MB"] << 20)
    split_fastest = split_fastest and route == M.WG_STREAM_ROUTE
    out = []
    for it in range(qtiles * splits):
        qt, y = ((it // splits, it % splits) if split_fastest
                 else (it % qtiles, it // qtiles))
        s0, s1 = steps * y // splits, steps * (y + 1) // splits
        out.append((it % grid, qt * M.WG_ROWS, min(b, (qt + 1) * M.WG_ROWS),
                    s0 * step, s1 * step))
    return splits, grid, step, out


@pytest.mark.parametrize("ep", [288, 640, 672])
@pytest.mark.parametrize("kernel", ["min2", "compact_mask"])
def test_items_cover_every_pair_once(port, kernel, ep):
    """At B = 1, 77, 4096 and 32768 against db rows that are not a
    multiple of the 128-row stream step (and one that is): every (query
    row < B, db row < Wp) pair lies in exactly one item; every split is
    a non-empty run of whole steps, the last ending at Wp rounded up to
    the step (form (b)'s last step may pass the db by 64 rows, which
    the kernel's boxes zero-fill and its epilogue skips); the grid is
    within the SMs and each block walks its items."""
    M = port.M
    item_steps = {"min2": M.MIN2_ITEM_STEPS,
                  "compact_mask": M.COMPACT_ITEM_STEPS}[kernel]
    for wp in (64, 4032, 32768 + 64, 2621440):
        for b in BATCHES:
            splits, grid, step, items = _items(M, b, wp, ep, item_steps,
                                               H100_SMS)
            assert 1 <= splits <= min(-(-wp // step), H100_SMS)
            assert 1 <= grid <= H100_SMS and grid == min(len(items), H100_SMS)
            cover = np.zeros((-(-b // M.WG_ROWS), wp // WP_MULTIPLE), np.int64)
            for blk, q0, q1, w0, w1 in items:
                assert 0 <= blk < grid and q0 < q1 <= b
                assert w0 % step == 0 and w0 < w1 and w1 % step == 0
                cover[q0 // M.WG_ROWS,
                      w0 // WP_MULTIPLE:min(w1, wp) // WP_MULTIPLE] += 1
            assert (cover == 1).all()
            assert max(w1 for *_, w1 in items) == -(-wp // step) * step < wp + step


@pytest.mark.parametrize("kernel,b,rows,L,want", [
    ("min2", 32768, 2621440, 150, ("wg_kchunk", 33)),
    ("compact_mask", 2048, 2621440, 150, ("wg_kchunk", 33)),
    ("min2", 4096, 32768, 29903, ("wg_kchunk_stream", 8)),
    ("compact_mask", 1024, 32768, 29903, ("wg_kchunk_stream", 33))])
def test_splits_at_the_main_shapes(port, kernel, b, rows, L, want):
    """Phase 9's best-hit batch and K-mode compaction against one slab
    of 2,621,440 rows at 150 bp, and phase 12 (b)'s batches against
    32,768 rows at 29,903 bp: the splits whose items fill the 132 SMs
    (min2 at 150 bp: 128 query tiles x 33 splits are 32 items a block,
    where one split leaves 4 SMs idle; at 29,903 bp 16 x 8 = 128 items
    of 32 steps, where more splits add items faster than they shorten
    them at min2's item cost)."""
    ep = port.D.embed_width(L)
    plan = port.C.kernel_plan if kernel == "compact_mask" else port.M.kernel_plan
    assert plan(b, rows, ep, H100_SMS) == want


def _form_a_smem(c, nkp):
    fixed = (nkp * c["ROWS"] * c["PANEL"] + c["ZS"] * c["NA"] * 4
             + c["BAR_BYTES"] + c["SLACK"])
    ring = min(c["RING_A"], (c["SMEM_LIMIT"] - fixed) // (c["NA"] * c["PANEL"]))
    return ring, fixed + ring * c["NA"] * c["PANEL"]


def test_shared_memory_at_the_widest_rows(port):
    """Form (a) at its widest row (NKP_MAX panels, EP_A_MAX bytes) holds
    the resident rows, a ring of at least a whole step's chunks, the zc
    ring, the barriers (RING_A full and empty, ZS, two) and the
    alignment slack within 232,448 bytes, and one panel more would not
    leave a step's chunks; form (b)'s ring of RING_B stages of 256 query
    and 128 db rows fits at any width."""
    c = {**_constants("wg_tile.cuh"), **_constants("wg_long.cuh")}
    assert c["SMEM_LIMIT"] == SMEM_MAX
    for nkp in range(3, c["NKP_MAX"] + 1):
        ring, smem = _form_a_smem(c, nkp)
        assert nkp <= ring <= c["RING_A"] and smem <= SMEM_MAX
    assert _form_a_smem(c, c["NKP_MAX"]) == (8, 231936)
    assert _form_a_smem(c, c["NKP_MAX"] + 1)[0] < c["NKP_MAX"] + 1
    assert (2 * c["RING_A"] + c["ZS"] + 2) * 8 <= c["BAR_BYTES"]
    stage_b = (c["ROWS"] + c["NB"]) * c["PANEL"]
    smem_b = (c["RING_B"] * stage_b + c["ZS"] * c["NB"] * 4 + c["BAR_BYTES"]
              + c["SLACK"])
    assert smem_b == 200192 <= SMEM_MAX
    assert (2 * c["RING_B"] + c["ZS"] + 2) * 8 <= c["BAR_BYTES"]


def test_mirrored_constants_equal_the_sources(port):
    """WG_ROWS, WG_KCHUNK_STEP, WG_STREAM_STEP and WG_RESIDENT_EP_MAX are
    wg_long.cuh's ROWS, NA, NB and EP_A_MAX (NKP_MAX panels of 128
    bytes); both kernels launch their long routes from it through its
    one choice of form (by_form: form (a) for 3 to NKP_MAX panels, else
    form (b)), and neither runs the split tile any more."""
    M = port.M
    c = {**_constants("wg_tile.cuh"), **_constants("wg_long.cuh")}
    assert (M.WG_ROWS, M.WG_KCHUNK_STEP, M.WG_STREAM_STEP) == (
        c["ROWS"], c["NA"], c["NB"])
    assert M.WG_RESIDENT_EP_MAX == c["EP_A_MAX"] == c["NKP_MAX"] * c["PANEL"]
    long_text = (CSRC / "wg_long.cuh").read_text()
    assert "EP > EP_A_MAX ? 0 : panels(EP)" in long_text
    for nkp in (3, 4, 5):
        assert f"case {nkp}: return f(std::integral_constant<int, {nkp}>());" in long_text
    assert "default: return f(std::integral_constant<int, 0>());" in long_text
    for src, kernel in (("min2.cu", "min2_wgchunk_kernel"),
                        ("compact.cu", "compact_wgchunk_kernel")):
        text = (CSRC / src).read_text()
        assert '#include "wg_long.cuh"' in text
        assert "wg_long::by_form(EP," in text
        assert f"{kernel}<NKP>" in text
        assert '#include "split_tile.cuh"' not in text
        assert "kchunk_scan(" not in text


def test_plan_is_cached(port):
    """The split search runs once per shape: the second call hits the
    cache."""
    M = port.M
    M.long_plan.cache_clear()
    M.long_plan(4096, 32768, 119616, H100_SMS, M.MIN2_ITEM_STEPS)
    M.long_plan(4096, 32768, 119616, H100_SMS, M.MIN2_ITEM_STEPS)
    info = M.long_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)


def test_zc_is_a_tma_source_on_every_route(port):
    """Every route of both wrappers copies zc by TMA: the wrappers check
    its alignment whatever the width (no branch on EP before the
    check)."""
    import inspect

    for fn in (port.M.min2, port.C.compact_mask):
        src = inspect.getsource(fn)
        assert "check_tma_zc(zc)" in src
        assert "SPLIT_EP_MAX" not in src
