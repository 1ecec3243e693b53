"""Per-stage wall-time timers, throughput counters and the profiler hook
of ``smafa_tpu.utils.profiling``:

- ``StageTimers``: per-stage cumulative timers and counters; the hot
  loop cost is two ``perf_counter`` calls per stage;
- ``maybe_trace``: with ``SMAFA_TPU_TRACE_DIR`` set, the block runs
  under ``torch.profiler`` (CPU activity, and CUDA activity on a card)
  and its Chrome trace is written into that directory, viewable in
  Perfetto or ``chrome://tracing``; without it, the hook does nothing.
  On a card it warns when the trace holds fewer kernel events of one of
  the port's kernels than its wrapper launched in the block, or no
  kernel at all: one trace taken late in a long-running process lost
  half its kernel events, cause not found (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import contextlib
import logging
import os
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


@contextlib.contextmanager
def maybe_trace(cuda: bool = False, rank: int | None = None):
    """torch.profiler trace of the block into ``SMAFA_TPU_TRACE_DIR`` when
    it is set, else no-op: CPU activity, with ``cuda`` also the card's.
    The trace file, ``smafa-<pid>.pt.trace.json``, names ``rank`` when
    given (a multi-process run: ``smafa-rank<r>-<pid>.pt.trace.json``)."""
    trace_dir = os.environ.get("SMAFA_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    tag = "" if rank is None else f"rank{rank}-"
    path = os.path.join(trace_dir, f"smafa-{tag}{os.getpid()}.pt.trace.json")
    os.makedirs(trace_dir, exist_ok=True)
    logger.info("Writing torch.profiler trace to %s", path)
    before = _launches() if cuda else {}
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    if cuda:
        lost = lost_kernel_events(prof, {
            k: n - before[k] for k, n in _launches().items()})
        if lost:
            logger.warning("torch.profiler trace %s lost kernel events "
                           "(kernel: events in the trace / launches): %s",
                           path, lost)


def _launches() -> dict[str, int]:
    """Launches so far of each of the port's kernels, by the name its
    CUDA kernels share."""
    from smafa_tpu_torch.ops import compact, hist, kstats, min2, min_count

    return {"min2": min2.launches, "compact": compact.launches,
            "kstats": kstats.launches, "min_count": min_count.launches,
            "hist": hist.launches}


def lost_kernel_events(prof, launched: dict[str, int]) -> dict:
    """{name: (events, launches)} for each kernel name whose device events
    in the profile ``prof`` are fewer than ``launched[name]`` (a launch
    runs one kernel named ``<name>_...`` or more, in the anonymous
    namespace of its source), and {"any kernel": (0, 1)} when the
    profile holds no device event at all."""
    from torch.autograd import DeviceType

    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    lost = {k: (sum(f"::{k}_" in x for x in names), n)
            for k, n in launched.items()}
    lost = {k: v for k, v in lost.items() if v[0] < v[1]}
    if not names:
        lost["any kernel"] = (0, 1)
    return lost
