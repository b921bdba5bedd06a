"""Per-stage wall-clock / throughput counters.

The reference captures a start time and never reports it (reference
main.cpp:59); here --profile prints a per-stage breakdown to stderr, and
the same timers drive bench.py diagnostics.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager


class StageTimer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.seconds: dict[str, float] = defaultdict(float)
        self.bytes: dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str, nbytes: int = 0):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.bytes[name] += nbytes

    def report(self, label: str = "") -> None:
        if not self.enabled or not self.seconds:
            return
        total = sum(self.seconds.values())
        print("[profile]%s total %.3fs" % (" " + label if label else "", total),
              file=sys.stderr)
        for name in sorted(self.seconds, key=self.seconds.get, reverse=True):
            s = self.seconds[name]
            b = self.bytes[name]
            rate = " %7.1f MB/s" % (b / 1e6 / s) if b and s > 0 else ""
            print("[profile]   %-12s %7.3fs %5.1f%%%s"
                  % (name, s, 100 * s / total if total else 0, rate),
                  file=sys.stderr)


NULL_TIMER = StageTimer(False)
