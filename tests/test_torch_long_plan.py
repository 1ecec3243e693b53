"""The launch plan past 64 bp, on the CPU: which route and how many db
splits each kernel gets, and the constants the plan mirrors from the
CUDA sources.

``ops/min2.py``'s ``launch_plan`` and ``live_plan`` are kstats' and
min_count's plan. Up to EP = 256 bytes (L <= 64) they take the split
tile at two blocks an SM; past it the K-chunked split tile at one block
an SM: "kchunk", query rows resident, up to EP = 672 (the widest whose
rows and a 3-stage ring of db chunks fit the 232,448 bytes a block can
use), and "kchunk_stream" past it, with ``split_count`` splits over the
live 64-row tiles. min2 and compact_mask take the wgmma tiles
(``kernel_plan``: ``short_plan`` up to 64 bp,
tests/test_torch_wg_plan.py; ``long_plan`` past it,
tests/test_torch_wg_long_plan.py).

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
            "kstats": M.live_plan(b, rows, ep, H100_SMS),
            "compact_mask": port.C.kernel_plan(b, rows, ep, H100_SMS),
            "min_count": M.live_plan(b, rows, ep, H100_SMS)}


@pytest.mark.parametrize("ep,want", [(256, "split"), (288, "kchunk"),
                                     (672, "kchunk"), (704, "kchunk_stream"),
                                     (119616, "kchunk_stream")])
def test_routes_at_the_boundaries(port, ep, want):
    """EP 256 (64 bp), 288 (the first K-chunked width, 65-72 bp), 672
    (168 bp, form (a)'s last), 704 (the 32-byte step past it) and 119,616
    (29,903 bp): kstats and min_count take the route named, past 64 bp
    with splits over one block an SM, at 64 bp the split tile; min2 and
    compact_mask the wgmma tiles: the short route at 64 bp, past it
    ``long_plan``'s routes (their own form (a) ends at 640)."""
    M = port.M
    short = {"min2": M.MIN2_ITEM_STEPS, "compact_mask": M.COMPACT_ITEM_STEPS}
    for b, rows in ((1, 64), (77, 32768), (1024, 32768), (4096, 2621440),
                    (32768, 2621440), (65536, 64)):
        plans = _plans(port, b, rows, ep)
        tiles = rows // WP_MULTIPLE
        for kernel, (route, s) in plans.items():
            if ep <= M.SPLIT_EP_MAX and kernel in short:
                assert route == M.WG_ROUTE, kernel
                assert s == M.short_plan(b, rows, H100_SMS, short[kernel])
            elif kernel in short:
                assert route == ("wg_kchunk" if ep <= M.WG_RESIDENT_EP_MAX
                                 else "wg_kchunk_stream"), kernel
                assert (route, s) == M.long_plan(b, rows, ep, H100_SMS,
                                                 short[kernel])
            elif ep <= M.SPLIT_EP_MAX:
                assert route == "split", kernel
                assert s == M.split_count(b, rows, H100_SMS * M.BLOCKS_PER_SM)
            else:
                assert route == want, kernel
                assert s == M.split_count(b, rows,
                                          H100_SMS * M.CHUNK_BLOCKS_PER_SM)
            assert 1 <= s <= tiles


def test_chunk_splits_fill_one_wave_and_never_exceed_the_live_tiles(port):
    """Past 64 bp: S <= the live tiles, ceil(B / 256) x S blocks within
    the 132 one-block slots, one split once the query tiles fill them;
    the phase 9 and phase 12 (b) shapes get 1, 8 and 33 splits."""
    M = port.M
    for ep in (288, 608, 1216, 119616):
        for b in (1, 77, 256, 1024, 4096, 32768, 33792, 1 << 20):
            for n_valid in (1, 37, 64, 3001, 32768, 2621440):
                route, s = M.live_plan(b, n_valid, ep, H100_SMS)
                tiles = -(-n_valid // WP_MULTIPLE)
                qtiles = -(-b // M.BM)
                assert route.startswith("kchunk") and 1 <= s <= tiles
                if qtiles >= H100_SMS:
                    assert s == 1
                else:
                    assert qtiles * s <= H100_SMS
                    assert s == tiles or qtiles * (s + 1) > H100_SMS
    assert M.launch_plan(32768, 2621440, 608, H100_SMS) == ("kchunk", 1)
    assert M.live_plan(4096, 2621440, 608, H100_SMS) == ("kchunk", 8)
    assert M.live_plan(1024, 32768, 119616, H100_SMS) == (
        "kchunk_stream", 33)
    assert M.live_plan(0, 32768, 608, H100_SMS) == ("none", 0)
    assert M.live_plan(77, 0, 608, H100_SMS) == ("none", 0)


def test_mirrored_constants_equal_the_sources(port):
    """ops/min2.py's BM, BLOCKS_PER_SM, SPLIT_EP_MAX, CHUNK_BLOCKS_PER_SM
    and RESIDENT_EP_MAX are split_tile.cuh's S_WARPS * 32,
    S_BLOCKS_PER_SM, S_KS * 32, K_BLOCKS_PER_SM and RESIDENT_EP_MAX; the
    chunk kernels of kstats and min_count launch with K_BLOCKS_PER_SM
    and switch forms at RESIDENT_EP_MAX, min2 and compact_mask run no
    split tile any more, and no first-version loop is left (scan_tile.cuh
    is gone)."""
    M = port.M
    c = _constants("split_tile.cuh")
    assert M.BM == c["S_WARPS"] * 32
    assert M.BLOCKS_PER_SM == c["S_BLOCKS_PER_SM"]
    assert M.SPLIT_EP_MAX == c["S_KS"] * 32
    assert "constexpr int K_CHUNK = S_KS * 32;" in (CSRC / "split_tile.cuh").read_text()
    assert M.CHUNK_BLOCKS_PER_SM == c["K_BLOCKS_PER_SM"]
    assert M.RESIDENT_EP_MAX == c["RESIDENT_EP_MAX"]
    for src in ("min2.cu", "kstats.cu", "compact.cu", "min_count.cu"):
        text = (CSRC / src).read_text()
        split = src in ("kstats.cu", "min_count.cu")
        assert ("__launch_bounds__(S_THREADS, K_BLOCKS_PER_SM)" in text) == split
        assert ("EP <= RESIDENT_EP_MAX" in text) == split
        assert ('#include "split_tile.cuh"' in text) == split
        assert "launch_long" not in text and "scan_tile" not in text
    assert "min2_long_kernel" not in (CSRC / "min2.cu").read_text()
    assert "kstats_kernel(" not in (CSRC / "kstats.cu").read_text()
    assert "compact_long_kernel" not in (CSRC / "compact.cu").read_text()
    assert "min_count_kernel" not in (CSRC / "min_count.cu").read_text()
    assert not (CSRC / "scan_tile.cuh").exists()


def test_form_a_limit_is_the_widest_that_fits(port):
    """Form (a)'s shared memory, 256 x (EP + 16) bytes of query rows plus
    KQ_STAGES x (64 x 272 bytes of db chunk + 64 zc), fits 232,448 bytes
    at RESIDENT_EP_MAX (212,736 at 150 bp) and not 32 bytes past it; form
    (b)'s KS_STAGES x (320 x 272 + 64 x 4) fits at every EP."""
    c = _constants("split_tile.cuh")
    stride = c["S_KS"] * 32 + c["S_PAD"]  # K_STRIDE

    def form_a(ep):
        return (c["S_WARPS"] * 32 * (ep + c["S_PAD"])
                + c["KQ_STAGES"] * (c["S_BN"] * stride + c["S_BN"] * 4))

    assert form_a(608) == 212736
    assert form_a(port.M.RESIDENT_EP_MAX) <= SMEM_MAX < form_a(
        port.M.RESIDENT_EP_MAX + 32)
    form_b = c["KS_STAGES"] * ((c["S_WARPS"] * 32 + c["S_BN"]) * stride
                               + c["S_BN"] * 4)
    assert form_b == 174592 <= SMEM_MAX


def test_wrappers_plan_by_kernel(port):
    """Every wrapper asks for the one plan (no per-kernel argument), and
    no C entry refuses more than one split past 64 bp: each checks only
    1 <= splits <= the (live) 64-row tiles."""
    src = {m: inspect.getsource(f) for m, f in (
        ("min2", port.M.min2), ("kstats", port.KS.kstats),
        ("compact_mask", port.C.compact_mask), ("min_count", port.MC.min_count))}
    assert "chunked" not in "".join(src.values())
    assert "chunked" not in inspect.signature(port.M.launch_plan).parameters
    assert "chunked" not in inspect.signature(port.M.live_plan).parameters
    for name in ("min2.cu", "kstats.cu", "compact.cu", "min_count.cu"):
        text = (CSRC / name).read_text()
        assert "splits != 1" not in text, name
        assert re.search(r"splits < 1 \|\| splits > ", text), name
