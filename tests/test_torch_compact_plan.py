"""compact_mask's launch plan (``compact.kernel_plan``, which the wrapper
calls: ``ops/min2.py:short_plan`` up to 64 bp, ``long_plan`` past it),
on the CPU: the route and db splits by window width and batch, and how
the splits cover the db's 64-row steps. Split off test_torch_compact.py,
which keeps the mask's parity tests.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import types

import numpy as np
import pytest

WP_MULTIPLE = 64  # smafa_tpu_torch.ops.distance.WP_MULTIPLE


@pytest.fixture(scope="module")
def port():
    import torch

    from smafa_tpu_torch.ops import compact, distance, min2

    return types.SimpleNamespace(torch=torch, D=distance, C=compact, M=min2)


@pytest.mark.parametrize("b,wp,want", [(4096, 1 << 20, 33), (8192, 1 << 20, 33),
                                       (1, 70016, 132), (77, 70016, 132)])
def test_compact_plan_covers_the_db(port, b, wp, want):
    """The short route's db splits at the compaction's shapes (the query
    smoke's 4096 tie rows and K-mode's 8192 rows x 2^20 windows: 16 x 33
    and 32 x 33 items on 132 persistent blocks; B = 1 and 77 x 70,001
    rows) on an H100's 132 SMs: 1 <= S <= steps, and the kernel's cut
    (split i of S walks steps steps * i // S up to steps * (i + 1) // S
    of 64 rows) gives every split a step and every 64-row step one
    split."""
    route, s = port.C.kernel_plan(b, wp, 256, 132)
    steps = wp // WP_MULTIPLE
    assert route == port.M.WG_ROUTE and s == want and 1 <= s <= steps
    cover = np.zeros(steps, np.int64)
    for i in range(s):
        t0, t1 = steps * i // s, steps * (i + 1) // s
        assert t1 > t0
        cover[t0:t1] += 1
    assert (cover == 1).all()


def test_compact_plan_routes_by_width(port):
    """Windows past 64 bp (EP > 256) take the long routes, query rows
    resident up to 160 bp ("wg_kchunk") and streamed past it
    ("wg_kchunk_stream"), with ``long_plan``'s splits, whose items cover
    at least 95% of the 132 SMs; up to 64 bp the short
    route, the wgmma tile, at any batch, with ``short_plan``'s splits."""
    for seq_len in (3, 60, 64, 65, 150, 168, 169, 300):
        ep = port.D.embed_width(seq_len)
        for b in (1, 77, 4096, 65535 * 32):
            route, s = port.C.kernel_plan(b, 70016, ep, 132)
            assert 1 <= s <= 70016 // WP_MULTIPLE
            if seq_len > 64:
                assert route == ("wg_kchunk" if seq_len <= 160
                                 else "wg_kchunk_stream")
                assert s == port.M.long_plan(b, 70016, ep, 132,
                                             port.M.COMPACT_ITEM_STEPS)[1]
                step = 64 if seq_len <= 160 else 128
                qt, steps = -(-b // 256), -(-70016 // step)
                assert min(qt * s, 132) >= 0.95 * min(132, qt * steps)
            else:
                assert route == port.M.WG_ROUTE
                assert s == port.M.short_plan(b, 70016, 132,
                                              port.M.COMPACT_ITEM_STEPS)
