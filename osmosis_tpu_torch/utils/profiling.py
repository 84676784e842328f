"""Phase timers (port of ``osmosis_tpu/utils/profiling.py``): wall time
per named phase of a run, accumulated and summarised at its end."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


class PhaseTimers:
    """Wall time and calls per phase name; safe to use from several threads
    (the restore pipeline's async saver times its phase beside the chain's)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        with self._lock:
            rows = sorted(self.totals.items(), key=lambda kv: kv[1], reverse=True)
            return "\n".join(["phase timings:"] + [
                f"  {name:24s} {total:8.2f}s / {self.counts[name]} calls" for name, total in rows])
