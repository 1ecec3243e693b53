"""Best-hit query through the port's CLI prints what smafa_tpu's prints,
each package querying the db the other one wrote: cases 21-41 of
test_torch_query.py's BEST_HIT_CASES (golden file x flags x format)."""

from __future__ import annotations

import pytest

from test_torch_query import BEST_HIT_CASES, _cpu, check_best_hit  # noqa: F401


@pytest.mark.parametrize("fname,extra,fmt", BEST_HIT_CASES[21:42])
def test_best_hit_matches_jax(capsys, tmp_path, fname, extra, fmt):
    check_best_hit(capsys, tmp_path, fname, extra, fmt)
