"""The short route's launch plan (``ops/min2.py:short_plan``, the
warp-specialised wgmma tile of csrc/wg_scan.cuh), on the CPU: every db
row covered once by whole 64-row steps, the persistent grid within the
SMs, the db's trailing 64-row half of a 128-row pair, the splits min2
and compact_mask get, the constants the plan mirrors from the sources;
and kstats' and min_count's plans over their live rows (``live_plan``)
pinned at the main shapes.

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
BATCHES = (1, 16, 77, 512, 4096, 32768)
ROWS = (64, 128 + 64, 1 << 20, (1 << 20) + 64)


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import compact, distance, hist, min2

    return types.SimpleNamespace(torch=torch, C=compact, D=distance,
                                 H=hist, M=min2)


def _constants(name: str) -> dict[str, int]:
    """The ``constexpr int NAME = <integer>;`` lines of a source."""
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _items(M, b: int, wp: int, item_steps: int, sms: int):
    """The kernel's items in its order (item it: query tile it % qtiles
    against split it // qtiles, run by block it % grid), as (block,
    first query row, end query row, first db row, end db row)."""
    splits = M.short_plan(b, wp, sms, item_steps)
    qtiles, steps = -(-b // M.WG_ROWS), wp // M.WG_STEP
    grid = min(qtiles * splits, sms)  # csrc/wg_scan.cuh launch
    out = []
    for it in range(qtiles * splits):
        qt, y = it % qtiles, it // qtiles
        s0 = steps * y // splits
        s1 = steps * (y + 1) // splits
        out.append((it % grid, qt * M.WG_ROWS,
                    min(b, (qt + 1) * M.WG_ROWS), s0 * M.WG_STEP,
                    s1 * M.WG_STEP))
    return splits, grid, out


@pytest.mark.parametrize("wp", ROWS)
@pytest.mark.parametrize("kernel", ["min2", "compact_mask"])
def test_items_cover_every_pair_once(port, kernel, wp):
    """At each batch: every (query row < B, db row < Wp) pair lies in
    exactly one item; every split is a non-empty run of whole 64-row
    steps, the last ending at Wp itself (at Wp = 64 and Wp = 2^20 + 64
    the trailing 64 rows are a step of their own, not half of a 128-row
    one); the grid is within the SMs and each block walks its items."""
    M = port.M
    steps_of = {"min2": M.MIN2_ITEM_STEPS,
                "compact_mask": M.COMPACT_ITEM_STEPS}[kernel]
    for b in BATCHES:
        splits, grid, items = _items(M, b, wp, steps_of, H100_SMS)
        assert 1 <= splits <= min(wp // WP_MULTIPLE, H100_SMS)
        assert 1 <= grid <= H100_SMS and grid == min(len(items), H100_SMS)
        cover = np.zeros((-(-b // M.WG_ROWS), wp // WP_MULTIPLE), np.int64)
        for blk, q0, q1, w0, w1 in items:
            assert 0 <= blk < grid and q0 < q1 <= b
            assert w0 % WP_MULTIPLE == 0 and w1 % WP_MULTIPLE == 0
            assert 0 <= w0 < w1 <= wp
            cover[q0 // M.WG_ROWS, w0 // WP_MULTIPLE:w1 // WP_MULTIPLE] += 1
        assert (cover == 1).all()
        assert max(w1 for *_, w1 in items) == wp


@pytest.mark.parametrize("b,min2_s,compact_s", [
    (1, 132, 132), (16, 132, 132), (77, 132, 132), (512, 66, 66),
    (4096, 8, 33), (8192, 4, 33), (32768, 1, 33)])
def test_splits_at_the_main_shapes(port, b, min2_s, compact_s):
    """The splits at 2^20 db rows on 132 SMs: compact_mask fills the
    card (33 splits x 16 or 32 query tiles: 4 or 8 items a block);
    min2, whose every split restarts its rows' running best, takes the
    fewest splits that fill a wave (32768 reads: 128 query tiles, one
    split), as the card measured fastest."""
    M, C = port.M, port.C
    wp = 1 << 20
    assert M.kernel_plan(b, wp, 256, H100_SMS) == (M.WG_ROUTE, min2_s)
    assert C.kernel_plan(b, wp, 256, H100_SMS) == (M.WG_ROUTE, compact_s)
    for s, steps in ((min2_s, M.MIN2_ITEM_STEPS),
                     (compact_s, M.COMPACT_ITEM_STEPS)):
        assert M.short_plan(b, wp, H100_SMS, steps) == s


def test_routes_by_width(port):
    """min2 and compact_mask take the short route up to EP = 256 (64 bp)
    and long_plan's routes past it."""
    M, C = port.M, port.C
    for seq_len in (1, 3, 31, 60, 64, 65, 150, 168, 169, 300):
        ep = port.D.embed_width(seq_len)
        for b in (1, 77, 4096, 32768):
            for plan, steps in ((M.kernel_plan, M.MIN2_ITEM_STEPS),
                                (C.kernel_plan, M.COMPACT_ITEM_STEPS)):
                route, s = plan(b, 70016, ep, H100_SMS)
                if seq_len <= 64:
                    assert route == M.WG_ROUTE
                else:
                    assert (route, s) == M.long_plan(b, 70016, ep, H100_SMS,
                                                     steps)


def test_plan_is_cached(port):
    """The split search runs once per shape: the second call hits the
    cache."""
    M = port.M
    M.short_plan.cache_clear()
    M.short_plan(4096, 1 << 20, H100_SMS, M.MIN2_ITEM_STEPS)
    M.short_plan(4096, 1 << 20, H100_SMS, M.MIN2_ITEM_STEPS)
    info = M.short_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)


def test_mirrored_constants_equal_the_sources(port):
    """WG_ROWS and WG_STEP are wg_scan.cuh's ROWS and N, the route's
    widest embedding (2 panels of 128 bytes) is SPLIT_EP_MAX, and a
    block's ring fits the shared memory a block can use at either panel
    count (1 to 32 bp, 2 to 64 bp); compact_mask stores 16 bytes a row
    only where rows are 16-byte aligned (Wp % 128 == 0), else 8. kstats'
    probes are keys.KSTATS_PROBES and its pair counts flush before 16
    columns a block overflow 16 bits; all four scans launch the short
    route from wg_scan.cuh up to its EP_MAX (kstats and min_count
    through its one choice of panels, kstats with byte lanes below 64
    bp), and the split tile is gone."""
    M = port.M
    c = {**_constants("wg_tile.cuh"), **_constants("wg_scan.cuh")}
    assert M.WG_ROWS == c["ROWS"] and M.WG_STEP == c["N"]
    assert M.SPLIT_EP_MAX == 2 * c["PANEL"]
    for nkp in (1, 2):
        smem = (c["RING"] * (nkp * c["N"] * c["PANEL"] + c["N"] * 4 + 16)
                + c["SLACK"])
        assert smem <= SMEM_MAX
    compact = (CSRC / "compact.cu").read_text()
    assert "epi.wide = (W & 127) == 0" in compact
    for src in ("min2.cu", "compact.cu", "kstats.cu", "min_count.cu"):
        text = (CSRC / src).read_text()
        assert '#include "wg_scan.cuh"' in text
        assert "wg_scan::EP_MAX" in text
        assert "split_tile" not in text and "mma_s8" not in text
    ks = _constants("kstats.cu")
    from smafa_tpu_torch.ops import keys

    assert ks["PROBES"] == keys.KSTATS_PROBES
    assert 16 * ks["PAIR_TILES"] < 1 << 16
    kst = (CSRC / "kstats.cu").read_text()
    assert "const bool bytes = seq_len < 64;" in kst
    for src, kernel in (("kstats.cu", "kstats_wg_kernel<NKP, true>"),
                        ("min_count.cu", "min_count_wg_kernel<NKP, WITH_COUNT>")):
        text = (CSRC / src).read_text()
        assert "wg_scan::by_panels(EP," in text and kernel in text, src
        assert "__launch_bounds__(wg_scan::THREADS, 1)" in text, src
    assert not (CSRC / "split_tile.cuh").exists()


def test_zc_must_be_a_tma_source(port):
    """The short route copies zc by TMA: a zc that is not 16-byte aligned
    is refused before a launch."""
    torch = port.torch
    zc = torch.zeros(128 + 4, dtype=torch.int32)
    port.M.check_tma_zc(zc[:128])
    with pytest.raises(ValueError, match="16-byte aligned"):
        port.M.check_tma_zc(zc[1:129])


# kstats' and min_count's plans (live_plan over the live rows) at the
# main shapes: the K-mode passes (16384 and 4096 reads x 2^20 + 37 rows),
# the cluster's batches against its centroids, the chip smoke's timed
# min_count shapes; (kstats, min_count) where their item costs differ.
# Past 64 bp live_plan is long_plan's over the live rows.
LIVE = {(1, 37, 256): ("wgmma", 1), (77, 3001, 256): ("wgmma", 47),
        (2048, 29321, 256): ("wgmma", 16), (32768, 29321, 256): ("wgmma", 1),
        (32768, 32768, 256): ("wgmma", 1), (8192, 16384, 256): ("wgmma", 4),
        (2048, 4096, 256): ("wgmma", 16),
        (16384, (1 << 20) + 37, 256): (("wgmma", 33), ("wgmma", 2)),
        (4096, (1 << 20) + 37, 256): (("wgmma", 33), ("wgmma", 8)),
        (1, (1 << 20) + 37, 256): ("wgmma", 132), (0, 5, 256): ("none", 0),
        (5, 0, 256): ("none", 0), (1024, 32768, 1216): ("wg_kchunk_stream", 33),
        (32768, 32768, 608): ("wg_kchunk", 1)}


def test_split_tile_plan_unchanged(port):
    """kstats' and min_count's plans at the main shapes, each kernel at
    its item cost: the short route up to 64 bp with ``short_plan``'s
    splits over the live rows (kstats, whose items restart nothing,
    takes more splits than min_count where the waves even out), the
    long routes past it, nothing at B = 0 or n_valid = 0; and the hist
    kernel's plan, which shares ``splits_for``, its 33 splits."""
    M = port.M
    for i, item in enumerate((M.KSTATS_ITEM_STEPS, M.MIN_COUNT_ITEM_STEPS)):
        for (b, n, ep), want in LIVE.items():
            want = want[i] if isinstance(want[0], tuple) else want
            assert M.live_plan(b, n, ep, H100_SMS, item) == want
            if want[0] == M.WG_ROUTE:
                live = -(-n // WP_MULTIPLE) * WP_MULTIPLE
                assert want[1] == M.short_plan(b, live, H100_SMS, item)
    assert not hasattr(M, "launch_plan") and not hasattr(M, "split_count")
    assert not hasattr(M, "BM") and not hasattr(M, "BLOCKS_PER_SM")
    assert port.H.launch_plan(16384, (1 << 20) + 37, 60, H100_SMS).splits == 33
    assert port.H.launch_plan(4096, (1 << 20) + 37, 60, H100_SMS).splits == 33
