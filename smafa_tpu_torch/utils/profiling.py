"""Per-stage wall-time timers and throughput counters — ``StageTimers``
from ``smafa_tpu.utils.profiling``. The profiler-trace hook of the JAX
package (``maybe_trace``) is not ported yet (ROADMAP.md queue 1).

The hot loop cost is two ``perf_counter`` calls per stage.
"""

from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger("smafa")


class StageTimers:
    """Cumulative wall-time per named stage + free-form counters."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.counters: dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def log_report(self, level: int = logging.INFO) -> None:
        total = self.elapsed()
        parts = ", ".join(
            f"{k} {v:.2f}s ({100 * v / total:.0f}%)" for k, v in self.seconds.items()
        )
        if parts:
            logger.log(level, "Stage times: %s (total %.2fs)", parts, total)
        comps = self.counters.get("comparisons", 0)
        if comps:
            scan_s = self.seconds.get("scan", total) or total
            logger.log(
                level,
                "Scanned %.3g query x window comparisons (%.3g/s overall, %.3g/s in-scan)",
                comps, comps / total, comps / scan_s,
            )
