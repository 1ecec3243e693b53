"""Shared test/fuzz helpers (used by tests/ and tools/resume_fuzz.py).

Shipped inside the package so the test suite and the standalone fuzz
drivers exercise identical crash semantics.
"""

from __future__ import annotations


class CrashError(RuntimeError):
    """Raised by CrashyFile at its programmed failure point."""


class CrashyFile:
    """Write-through wrapper that dies at the ``fail_at``-th write.

    With ``torn=True`` half of the failing string lands first — the torn
    partial line a real SIGKILL mid-`write(2)` leaves behind — which is
    exactly the case the resume baseline/truncation logic must clean up.
    """

    def __init__(self, f, fail_at: int, torn: bool = True):
        self._f = f
        self._writes = 0
        self._fail_at = fail_at
        self._torn = torn

    def write(self, s):
        self._writes += 1
        if self._writes == self._fail_at:
            if self._torn and len(s) > 1:
                self._f.write(s[: max(1, len(s) // 2)])
            raise CrashError(f"programmed crash at write {self._writes}")
        return self._f.write(s)

    def __getattr__(self, name):
        return getattr(self._f, name)
