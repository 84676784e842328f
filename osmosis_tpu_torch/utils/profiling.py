"""Tracing and profiling hooks (port of ``osmosis_tpu/utils/profiling.py``).

  * ``PhaseTimers`` / ``phase(name)``: wall time per named phase,
    accumulated into the process-wide ``TIMERS`` and summarised at a run's
    end;
  * ``device_trace(dir)``: a ``torch.profiler`` trace of the host and the
    card, written into ``dir`` as a Chrome trace;
  * ``enable_nan_debugging()``: autograd's anomaly mode, which raises where a
    backward makes a NaN.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


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


TIMERS = PhaseTimers()
phase = TIMERS.phase


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the CPU and, where there is a card, CUDA
    activity while the block runs, written into ``log_dir`` as
    ``trace-<pid>-<ns>.json`` (Chrome trace format, for chrome://tracing or
    Perfetto); a no-op when ``log_dir`` is empty or None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def enable_nan_debugging():
    """Raise where a NaN appears: ``torch.autograd.set_detect_anomaly(True,
    check_nan=True)``. Weaker than the JAX package's ``jax_debug_nans``,
    which checks the output of every primitive, forward included: anomaly
    mode checks only what each backward function returns, so a NaN made in
    a forward (or under ``torch.no_grad``, as in the prior sampler) passes
    until a gradient carries it, and a NaN that no gradient reaches passes
    unseen."""
    import torch

    torch.autograd.set_detect_anomaly(True, check_nan=True)
