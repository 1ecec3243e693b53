"""The hist kernel's launch plan (``smafa_tpu_torch/ops/hist.py``, the
mirror of ``csrc/hist.cu``'s routes, shared-memory layout, bin flushes
and persistent work items) on the CPU: every route's shared bytes fit a
block at every window it serves, its 16-bit bins are flushed before
they wrap, the work items cover every query row and db row once, and
the route follows the embedding width as the kernel picks it.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import types

import pytest

SMEM = 232_448  # shared bytes a block can use on the H100
WIDTHS = {"split": range(1, 65), "kchunk": range(65, 169),
          "kchunk_stream": range(169, 1024)}


@pytest.fixture(scope="module")
def port():
    from smafa_tpu_torch.ops import distance, hist, min2

    return types.SimpleNamespace(D=distance, H=hist, M=min2)


def _route(port, name):
    return next(r for r in port.H.ROUTES if r.name == name)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_shared_bytes_fit_every_width(port, name):
    """Ring, resident query rows, zc ring, bins, barriers and the
    alignment slack within 232,448 bytes, with a ring of 2 to 6 stages,
    for every L the route takes; the stage and the resident rows are
    whole 1024-byte swizzle atoms."""
    r = _route(port, name)
    for seq_len in WIDTHS[name]:
        ep = port.D.embed_width(seq_len)
        plan = port.H.launch_plan(4096, 1 << 20, seq_len, 132)
        assert plan.route == name
        stage = port.H.stage_bytes(r)
        fixed = port.H.fixed_bytes(r, seq_len, ep)
        assert plan.smem_bytes == fixed + plan.stages * stage <= SMEM
        assert 2 <= plan.stages <= port.H.RING_MAX
        assert (plan.stages + 1) * stage + fixed > SMEM or (
            plan.stages == port.H.RING_MAX)
        assert stage % 1024 == 0 and plan.bin_bytes % 16 == 0
        assert plan.bin_bytes == port.H.bin_bytes(r, seq_len)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_bins_flushed_before_they_wrap(port, name):
    """flush_steps steps of the most increments a 16-bit bin half can
    take a step stay below 65,536; copies of a row's bins: the N /
    copies columns of the lanes sharing one a step (a flush adds the
    copies, well inside int32); one copy a row: every column of a
    step."""
    r = _route(port, name)
    plan = port.H.launch_plan(16384, (1 << 20) + 37, WIDTHS[name][-1], 132)
    per_step = port.H.increments_per_step(r)
    assert per_step == (port.H.N // r.copies if r.copies else r.step)
    assert plan.flush_steps * per_step < 65536
    assert (plan.flush_steps + 1) * per_step >= 65536
    if r.copies:  # two warpgroups of 64 rows own their bins
        assert r.rows == 128 and r.rows_at != "streamed"
        assert r.copies in (2, 4)


@pytest.mark.parametrize("b, n_valid, seq_len, sms", [
    (1, 37, 60, 132), (63, 64, 3, 132), (65, 641, 150, 132),
    (16385, (1 << 20) + 37, 60, 132), (4096, 2_621_440, 150, 132),
    (1024, 32_768, 300, 132), (1024, 32_768, 1023, 132),
    (300, 70_001, 300, 114), (257, 5_000, 64, 7)])
def test_work_items_cover_every_row_once(port, b, n_valid, seq_len, sms):
    """Query tiles partition [0, b); each tile's items partition the db
    rows [0, n_valid) into nonempty runs of whole steps (the last one
    partial); every block of the grid runs an item, items going round
    the blocks; S <= the steps and <= the SMs."""
    plan = port.H.launch_plan(b, n_valid, seq_len, sms)
    r = _route(port, plan.route)
    items = port.H.work_items(plan, b, n_valid)
    qtiles, steps = -(-b // r.rows), -(-n_valid // r.step)
    assert 1 <= plan.splits <= min(steps, sms)
    assert len(items) == qtiles * plan.splits
    assert plan.grid == min(len(items), sms)
    assert {blk for blk, *_ in items} == set(range(plan.grid))
    by_tile: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for blk, q0, q1, w0, w1 in items:
        assert w0 < w1 and w0 % r.step == 0
        assert w1 == n_valid or w1 % r.step == 0
        by_tile.setdefault((q0, q1), []).append((w0, w1))
    tiles = sorted(by_tile)
    assert tiles[0][0] == 0 and tiles[-1][1] == b
    assert all(a[1] == c[0] for a, c in zip(tiles, tiles[1:]))
    for runs in by_tile.values():
        runs.sort()
        assert runs[0][0] == 0 and runs[-1][1] == n_valid
        assert all(a[1] == c[0] for a, c in zip(runs, runs[1:]))


def test_route_by_width_as_the_kernel_picks_it(port):
    """csrc/hist.cu's smafa_hist picks "split" up to EP = 256,
    "kchunk" up to EP = 672 (ops/hist.py RESIDENT_EP_MAX) and
    "kchunk_stream" past it; the plan agrees at every L, and its "split"
    route covers the widths of kstats' short route ("wgmma") up to 256."""
    assert port.H.RESIDENT_EP_MAX == 672
    for seq_len in range(1, 1024):
        ep = port.D.embed_width(seq_len)
        want = ("split" if ep <= 256 else "kchunk" if ep <= 672
                else "kchunk_stream")
        assert port.H.route_of(seq_len).name == want
        assert port.H.launch_plan(77, 1000, seq_len, 132).route == want
        if ep <= port.M.SPLIT_EP_MAX:
            assert port.M.live_plan(77, 1 << 20, ep, 132,
                                    port.M.KSTATS_ITEM_STEPS)[0] == "wgmma"
    assert [port.H.route_of(L).name for L in (64, 65, 168, 169)] == [
        "split", "kchunk", "kchunk", "kchunk_stream"]


def test_splits_fill_the_card(port):
    """At the K-mode smoke's shape the items fill 132 SMs exactly (33
    splits of 128 query tiles: 32 items a block); with one query tile
    every step is a split up to the SMs; never more splits than steps."""
    plan = port.H.launch_plan(16384, (1 << 20) + 37, 60, 132)
    assert (plan.splits, plan.grid) == (33, 132)
    assert (16384 // 128 * plan.splits) % 132 == 0
    assert port.H.launch_plan(1, 128 * 132 * 5, 60, 132).splits == 132
    assert port.H.launch_plan(1, 128 * 7, 60, 132).splits == 7
    for b in (1, 100, 256, 257, 5000, 40000):
        for n_valid in (1, 63, 64, 65, 4097, 100_000):
            plan = port.H.launch_plan(b, n_valid, 60, 132)
            assert 1 <= plan.splits <= -(-n_valid // 128)
