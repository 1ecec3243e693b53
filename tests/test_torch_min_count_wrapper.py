"""The min_count wrapper's contract on CPU tensors: the plain version
never counts a launch, and operands the kernel does not take raise.
Split off test_torch_min_count.py (its parity tests), whose helpers it
imports.

torch is imported by the ``port`` fixture, not at collection (see
test_torch_min2.py)."""

from __future__ import annotations

import numpy as np
import pytest

from smafa_tpu_torch.ops import keys as K
from test_torch_min_count import _case, _operands, _port, port  # noqa: F401


def test_min_count_cpu_never_counts_launches(port):
    port.M.launches = 0
    db, q = _case(60, 300, 16, 0)
    buf = np.zeros((320, 60), np.uint8)
    buf[:300] = db
    emb, zc = _operands(port, buf, 60)
    _port(port, q, emb, zc, 300, 60, K.packing_shift(60, 320))
    assert port.M.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "device", "shift",
                                 "n_valid"])
def test_min_count_rejects_bad_operands(port, bad):
    torch, D = port.torch, port.D
    db, q = _case(13, 128, 16, 1)
    emb, zc = D.embed_db(torch.from_numpy(db), 13, 128)
    q_emb = D.expand_embed_query(torch.from_numpy(q), 13)
    shift, n_valid = K.packing_shift(13, 128), 128
    if bad == "dtype":
        q_emb = q_emb.to(torch.int32)
    elif bad == "width":
        q_emb = q_emb[:, :32].contiguous()
    elif bad == "rows":
        emb, zc = emb[:100], zc[:100]
        n_valid = 100
    elif bad == "device":
        q_emb, emb, zc = (t.to("meta") for t in (q_emb, emb, zc))
    elif bad == "shift":
        shift = 3
    for n in ([129, -1] if bad == "n_valid" else [n_valid]):
        with pytest.raises((TypeError, ValueError)):
            port.M.min_count(q_emb, emb, zc, n, 13, shift)
