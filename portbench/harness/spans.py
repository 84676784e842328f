"""The program's own spans and counters (``osmosis_tpu_torch.utils.profiling``),
read in two more passes of a traced run, after the window and its traced
segments (pass A, which runs with the spans off, as the window does):

  * pass B: ``SEGMENTS`` segments with the spans on and no profiler: the
    host's time in each span, the counters, and the wall time of each
    synchronized segment;
  * pass C: ``SEGMENTS`` segments with the spans on under ``torch.profiler``,
    where each span is a user annotation. Each device operation is credited
    to the innermost span that holds the start of the host call that
    launched it, matched by correlation id on any thread (the pullback's
    kernels are launched from the autograd engine's thread while the
    caller waits in ``guided.pullback``); each idle gap between device
    operations to the innermost span that holds its midpoint, or to
    ``OUTSIDE``.

:func:`passes` takes the cell and the seed from the readers' context. The
window's program is gone by then, so it builds the program again from the
same seed, warms it up on one segment, runs both passes from one
``Driver``, and keeps the result on the context for the other readers. A
program without spans gives None, and so does every reader of them.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import time
import traceback
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from . import program, trace as tr, traffic as tf

SEGMENTS = 2
MARKER = "portbench.spans"
OUTSIDE = "outside spans"
UNET_SPANS = ("unet.forward", "guided.pullback")
COUNTERS = ("guided.steps", "guided.x_prev_steps", "guided.phi_iters", "unet.calls")
HOST_CALLS = ("cuda_runtime", "cuda_driver")
CUDA_API = "cu"  # the runtime's and the driver's calls (cuda*, cu*), where events carry no kind


def innermost(starts: np.ndarray, ends: np.ndarray, points: np.ndarray) -> np.ndarray:
    """For each point, the index of the innermost of the nested intervals
    (sorted by start) that holds it, or -1: the one that starts last among
    those holding it."""
    if not len(starts):
        return np.full(len(points), -1, np.int64)
    parent = np.full(len(starts), -1, np.int64)
    stack: List[int] = []
    for i in range(len(starts)):
        while stack and ends[stack[-1]] < starts[i]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    cand = np.searchsorted(starts, points, side="right") - 1
    for _ in range(64):
        bad = (cand >= 0) & (ends[np.maximum(cand, 0)] < points)
        if not bad.any():
            break
        cand[bad] = parent[cand[bad]]
    return cand


@dataclasses.dataclass
class HostPass:
    """Pass B."""
    wall_s: List[float]          # each synchronized segment
    spans: list                  # the program's SpanRecords
    counts: Dict[str, int]       # the counters' increase

    @property
    def steps(self) -> int:
        return self.counts["guided.steps"]

    def total_s(self, name: str) -> float:
        return sum(s.duration_ns for s in self.spans if s.name == name) * 1e-9

    def table(self) -> Dict[str, list]:
        """Each span's total and self seconds (its time outside its child
        spans), and each segment's ``guided.step`` seconds beside its wall
        time."""
        child = defaultdict(int)
        for s in self.spans:
            child[s.parent] += s.duration_ns
        total, own = defaultdict(int), defaultdict(int)
        for s in self.spans:
            total[s.name] += s.duration_ns
            own[s.name] += s.duration_ns - child[s.id]
        roots = sorted({s.root for s in self.spans})
        steps = [sum(s.duration_ns for s in self.spans if s.name == "guided.step" and s.root == r)
                 * 1e-9 for r in roots]
        return {"host_s_by_span": [[n, total[n] * 1e-9, own[n] * 1e-9]
                                   for n in sorted(total, key=lambda n: -total[n])],
                "segment_wall_s": self.wall_s, "segment_step_spans_s": steps}


@dataclasses.dataclass
class SpanTrace:
    """Pass C: the device's operations, each with the innermost span of
    its launch (``OUTSIDE`` where none holds it or no launch was found),
    and the spans themselves."""
    trace: tr.Trace
    dev_span: List[str]
    dev_unet: np.ndarray         # launched inside unet.forward or guided.pullback
    unmatched: int               # operations whose launch call was not found
    span_name: List[str]
    span_start: np.ndarray
    span_end: np.ndarray
    counts: Dict[str, int]

    @classmethod
    def build(cls, trace: tr.Trace, spans, launch_ns: np.ndarray, counts) -> "SpanTrace":
        """``spans`` (name, start, end) of one thread; ``launch_ns`` the
        start of each device operation's launch call (-1: not found)."""
        spans = sorted(spans, key=lambda s: s[1])
        names = [s[0] for s in spans]
        st = np.array([s[1] for s in spans], np.int64)
        en = np.array([s[2] for s in spans], np.int64)
        found = launch_ns >= 0
        idx = np.where(found, innermost(st, en, launch_ns), -1)
        unet = np.array([n in UNET_SPANS for n in names], bool)
        us = innermost(st[unet], en[unet], launch_ns) if unet.any() else np.full(len(idx), -1)
        return cls(trace, [names[i] if i >= 0 else OUTSIDE for i in idx], found & (us >= 0),
                   int((~found).sum()), names, st, en, dict(counts))

    @property
    def steps(self) -> int:
        return self.counts["guided.steps"]

    def busy_s(self, mask: Optional[np.ndarray] = None) -> float:
        """The union of the device's operations (those of ``mask``)."""
        t = self.trace
        if mask is not None:
            t = dataclasses.replace(t, dev_name=[n for n, m in zip(t.dev_name, mask) if m],
                                    dev_start=t.dev_start[mask], dev_end=t.dev_end[mask])
        return t.busy_s()

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        t = self.trace
        dur = t.dev_end - t.dev_start
        by_span, pairs = defaultdict(int), defaultdict(int)
        for s, n, d in zip(self.dev_span, t.dev_name, dur):
            by_span[s] += int(d)
            pairs[(s, tr.short(n))] += int(d)
        bs, be = t.busy_intervals()
        gap_s = np.concatenate([[t.start_ns], be])
        gap_e = np.concatenate([bs, [t.end_ns]])
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        idx = innermost(self.span_start, self.span_end, (gap_s + gap_e) // 2)
        idle = defaultdict(int)
        for i, s, e in zip(idx, gap_s, gap_e):
            idle[self.span_name[i] if i >= 0 else OUTSIDE] += int(e - s)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])  # noqa: E731
        return {"idle_by_span": [[n, v * 1e-9] for n, v in order(idle)],
                "device_by_span": [[s, k, v * 1e-9] for (s, k), v in order(pairs)[:top]],
                "device_s_by_span": [[n, v * 1e-9] for n, v in order(by_span)]}


@dataclasses.dataclass
class Passes:
    host: HostPass
    device: SpanTrace


def reduce(prof, names, counts) -> SpanTrace:
    """Pass C's events of a stopped ``torch.profiler.profile``: the device's
    operations inside the ``MARKER`` span, the host's launch calls (any
    thread) by correlation id, and the user annotations of the program's
    span ``names`` on the marker's thread. Where the events carry no
    activity kind (``_KinetoEvent.activity_type`` is newer than some
    torch builds), a host call is a CPU event named for the CUDA API, and
    the device's copies of the annotations are told by their names."""
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == MARKER and "cpu" in str(e.device_type()).lower()]
    if not marks:
        raise RuntimeError(f"the trace holds no {MARKER!r} span")
    lo, hi = marks[0].start_ns(), marks[0].start_ns() + marks[0].duration_ns()
    main = marks[0].start_thread_id()
    dev, calls, spans, launches = [], {}, [], 0
    for e in events:
        start = e.start_ns()
        if start < lo or start > hi:
            continue
        name, kind = e.name(), tr._kind(e)
        on_device = "cuda" in str(e.device_type()).lower()
        if name in names or name == MARKER:  # an annotation, or its copy on the device
            if not on_device and name != MARKER and e.start_thread_id() == main:
                spans.append((name, start, start + e.duration_ns()))
        elif on_device:
            if not kind or any(k in kind for k in tr.DEVICE_ACTIVITIES):
                dev.append((name, start, start + e.duration_ns(), e.correlation_id()))
        elif any(k in kind for k in HOST_CALLS) or (not kind and name.startswith(CUDA_API)):
            calls[e.correlation_id()] = start
            launches += name.startswith(tr.LAUNCH_PREFIXES)
    arr = lambda rows, i: np.array([r[i] for r in rows], dtype=np.int64)  # noqa: E731
    trace = tr.Trace(lo, hi, [r[0] for r in dev], arr(dev, 1), arr(dev, 2), launches, [],
                     np.zeros(0, np.int64), np.zeros(0, np.int64))
    launch_ns = np.array([calls.get(r[3], -1) for r in dev], np.int64)
    return SpanTrace.build(trace, spans, launch_ns, counts)


def _profiling():
    """The program's ``utils/profiling``, or None where it has no spans."""
    from osmosis_tpu_torch.utils import profiling
    need = ("tracing", "span", "take_spans", "counters")
    return profiling if all(hasattr(profiling, n) for n in need) else None


def passes(ctx) -> Optional[Passes]:
    """Passes B and C of the run that ``ctx`` reads, run once and kept on
    ``ctx``; None without a trace, without spans in the program or where
    the passes fail (the traceback goes to standard error). Prints the
    ``span_breakdown`` line."""
    if not hasattr(ctx, "span_passes"):
        ctx.span_passes = None
        profiling = _profiling()
        cell, seed = getattr(ctx, "cell", None), getattr(ctx, "seed", None)
        if ctx.trace is not None and profiling is not None and cell is not None:
            try:
                ctx.span_passes = run_passes(cell, seed, profiling)
            except Exception:  # the run's other metrics and its check still print
                traceback.print_exc()
            if ctx.span_passes is not None:
                print("span_breakdown: " + json.dumps(summary(ctx.span_passes, ctx.outcome)))
    return ctx.span_passes


def summary(p: Passes, outcome) -> dict:
    """Pass C's idle and device time by span, pass B's host time by span,
    and what tracing costs the host: pass B's wall time a step over the
    window's."""
    out = p.device.breakdown()
    out.update(p.host.table())
    busy = p.device.busy_s()
    inside = p.device.busy_s(np.array([s != OUTSIDE for s in p.device.dev_span], bool))
    out["device_busy_in_spans_share"] = inside / busy if busy > 0 else None
    out["device_ops_unmatched"] = [p.device.unmatched, len(p.device.dev_span)]
    if outcome.steps and p.host.steps:
        window = outcome.window_s / outcome.steps
        out["tracing_cost_pct"] = 100.0 * (sum(p.host.wall_s) / p.host.steps / window - 1.0)
    out["counts"] = {"pass_b": p.host.counts, "pass_c": p.device.counts}
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_passes(cell, seed: int, profiling) -> Passes:
    """Build the cell's program from ``seed`` as ``Cell.run`` does, warm it
    up on one segment, then run pass B and pass C."""
    from .cell import Driver, start_profiler

    dev = cell.device
    cuda = dev.type == "cuda"
    st = program.settings(cell.dtype, dev)
    if cuda:
        program.set_tf32(False)
    model = cell.program(seed)
    segment = program.build_chain(cell.preset, model, cell.lanes)
    traffic = tf.Traffic(cell.mix, cell.P, cell.arch.image_size, seed, dev)
    k = traffic.x_prev_every if cell.P.gradient_x_prev else 0
    drive = Driver(segment, traffic, program.cold_phi(cell.preset, cell.lanes, dev), k)

    def counted(fn):
        before = profiling.counters()
        fn()
        after = profiling.counters()
        return {c: after[c] - before[c] for c in COUNTERS}

    with program.cudnn_algorithms(st.deterministic):
        drive.next()
        _sync(dev)
        gc.collect()
        gc.freeze()
        try:
            walls: List[float] = []

            def host_pass():
                with profiling.tracing():
                    for _ in range(SEGMENTS):
                        t0 = time.perf_counter()
                        drive.next()
                        _sync(dev)
                        walls.append(time.perf_counter() - t0)

            profiling.take_spans()
            counts = counted(host_pass)
            host = HostPass(walls, profiling.take_spans(), counts)
            prof = start_profiler(cuda)

            def device_pass():
                with profiling.tracing(), torch.profiler.record_function(MARKER):
                    for _ in range(SEGMENTS):
                        drive.next()
                        _sync(dev)

            counts = counted(device_pass)
            prof.__exit__(None, None, None)
            names = {s.name for s in profiling.take_spans()}
            device = reduce(prof, names, counts)
            del prof
        finally:
            gc.unfreeze()
    del model, segment, drive
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return Passes(host, device)
