"""Tracing and profiling hooks (port of ``osmosis_tpu/utils/profiling.py``).

  * ``PhaseTimers`` / ``phase(name)``: wall time per named phase,
    accumulated into the process-wide ``TIMERS`` and summarised at a run's
    end (the run log); while tracing is on, a phase is also a span;
  * ``span(name, **attrs)``: a span of the program's own layers (the
    guided chain's segment, step, phi fit, joint gradient and pullback, the
    UNet's forward, the fleet's segment). Off, the default, it is one shared
    null context: no allocation, no clock read. Inside ``tracing()`` each
    span is kept in memory as a :class:`SpanRecord` on ``torch.profiler``'s
    clock (epoch nanoseconds, ``time.time_ns``), and while a profiler runs
    it also opens ``torch.profiler.record_function(name)``, so the trace
    holds it as a user annotation beside the device's kernels;
    ``take_spans()`` returns the records and clears them;
  * ``count(name, n)`` / ``counters()`` / ``reset_counters()``: the
    process's counters, always on: ``guided.steps``, ``guided.x_prev_steps``,
    ``guided.phi_iters`` and ``unet.calls`` where the chain does the work,
    the UNet's CUDA graphs (``unet.graph_captures``, ``unet.graph_replays``,
    ``unet.graph_pullbacks``), and each kernel wrapper's launches
    (``<wrapper>.launches``; the GroupNorm kernels' ``kernel_launches``,
    ``param_sum_launches`` and ``film_sum_launches`` too), a graph's replay
    adding what its capture counted;
  * ``enable_nan_debugging()``: autograd's anomaly mode, which raises where a
    backward makes a NaN.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Mapping

import torch

_LOCK = threading.Lock()
_NULL = contextlib.nullcontext()
_TRACING = 0                      # open tracing() blocks
_RECORDS: List["SpanRecord"] = []
_OPEN = threading.local()         # each thread's stack of open spans
_IDS = itertools.count(1)
_COUNTS: Dict[str, int] = defaultdict(int)


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span. ``parent`` is the span open on the same thread when
    it began (0: none); ``root`` the outermost of them, which the spans of
    one chain segment share. Times are epoch nanoseconds."""
    name: str
    id: int
    parent: int
    root: int
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start", "annotation")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else 0
        self.root = stack[-1].root if stack else self.id
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        rec = SpanRecord(self.name, self.id, self.parent, self.root, threading.get_ident(),
                         self.start, end, self.attrs)
        with _LOCK:
            _RECORDS.append(rec)
        return False


def span(name: str, **attrs):
    """A context manager around one piece of the program's work (the
    module's docstring); a shared null context unless tracing is on."""
    if not _TRACING:
        return _NULL
    return _Span(name, attrs)


@contextlib.contextmanager
def tracing():
    """Keep the spans of the block, of every thread (nested blocks add up)."""
    global _TRACING
    with _LOCK:
        _TRACING += 1
    try:
        yield
    finally:
        with _LOCK:
            _TRACING -= 1


def take_spans() -> List[SpanRecord]:
    """The spans closed since the last call, in the order they closed."""
    global _RECORDS
    with _LOCK:
        out, _RECORDS = _RECORDS, []
    return out


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] += n


def count_all(counts: Mapping[str, int]):
    """Add each of ``counts`` to its counter."""
    with _LOCK:
        for name, n in counts.items():
            _COUNTS[name] += n


def counters() -> collections.Counter:
    """A copy of every counter (one never counted reads 0)."""
    with _LOCK:
        return collections.Counter(_COUNTS)


def reset_counters(*names: str):
    """Set the named counters, or all of them, to 0."""
    with _LOCK:
        for name in names or list(_COUNTS):
            _COUNTS[name] = 0


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
            with span(name):
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


def enable_nan_debugging():
    """Raise where a NaN appears: ``torch.autograd.set_detect_anomaly(True,
    check_nan=True)``. Weaker than the JAX package's ``jax_debug_nans``,
    which checks the output of every primitive, forward included: anomaly
    mode checks only what each backward function returns, so a NaN made in
    a forward (or under ``torch.no_grad``, as in the prior sampler) passes
    until a gradient carries it, and a NaN that no gradient reaches passes
    unseen."""
    torch.autograd.set_detect_anomaly(True, check_nan=True)
