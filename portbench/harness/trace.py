"""The device trace of a traced run: ``torch.profiler`` with CPU and CUDA
activity around the measured window, reduced to arrays once it stops.

The window is the span of a ``record_function`` marker that the run opens
around it, so the device's intervals, the host's launch calls and the host's
operators are all read on the profiler's one clock.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

MARKER = "portbench.window"
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    dev_name: List[str]           # device operations in the window
    dev_start: np.ndarray
    dev_end: np.ndarray
    launches: int                 # host launch calls in the window
    host_name: List[str]          # host operators of the window's thread
    host_start: np.ndarray
    host_end: np.ndarray

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_intervals(self) -> Tuple[np.ndarray, np.ndarray]:
        """The union of the device's operation intervals, as disjoint
        (starts, ends), clipped to the window."""
        if not len(self.dev_start):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        order = np.argsort(self.dev_start, kind="stable")
        s = np.clip(self.dev_start[order], self.start_ns, self.end_ns)
        e = np.clip(self.dev_end[order], self.start_ns, self.end_ns)
        reach = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > reach[:-1]
        idx = np.flatnonzero(new)
        return s[idx], np.append(reach[idx[1:] - 1], reach[-1])

    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) * 1e-9

    def device_time_s(self, pattern: str) -> float:
        """Device seconds of the operations whose names contain ``pattern``."""
        tot = sum(int(e - s) for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end)
                  if pattern in n)
        return tot * 1e-9


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def reduce(prof) -> Trace:
    """The window's events of a stopped ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == MARKER and "cpu" in str(e.device_type()).lower()]
    if not marks:
        raise RuntimeError(f"the trace holds no {MARKER!r} span")
    lo, hi = marks[0].start_ns(), marks[0].start_ns() + marks[0].duration_ns()
    main = marks[0].start_thread_id()
    dev, host, launches = [], [], 0
    for e in events:
        name = e.name()
        start = e.start_ns()
        if start < lo or start > hi or name == MARKER:
            continue
        kind = _kind(e)
        if "cuda" in str(e.device_type()).lower():
            if not kind or any(k in kind for k in DEVICE_ACTIVITIES):
                dev.append((name, start, start + e.duration_ns()))
        elif name.startswith(LAUNCH_PREFIXES):
            launches += 1
        elif ("cpu_op" in kind or not kind) and e.start_thread_id() == main:
            host.append((name, start, start + e.duration_ns()))
    arr = lambda rows, i: np.array([r[i] for r in rows], dtype=np.int64)  # noqa: E731
    return Trace(lo, hi, [r[0] for r in dev], arr(dev, 1), arr(dev, 2), launches,
                 [r[0] for r in host], arr(host, 1), arr(host, 2))


def short(name: str, width: int = 96) -> str:
    """A kernel's or operator's name without its template arguments, return
    type and parameter list."""
    s, out, depth = name.replace("(anonymous namespace)::", ""), [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out)
    if "(" in s and ("::" in s or s.startswith("void ")):
        s = s[:s.index("(")].split()[-1]
    return s[:width]


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the device's idle
    time by the host operator that the window's thread runs at each gap's
    midpoint (the innermost one; "host: no operator" where it runs none, as
    in Python code or while the autograd engine's thread works)."""
    by_op: Dict[str, int] = defaultdict(int)
    for n, s, e in zip(tr.dev_name, tr.dev_start, tr.dev_end):
        by_op[short(n)] += int(e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    bs, be = tr.busy_intervals()
    gap_s = np.concatenate([[tr.start_ns], be])
    gap_e = np.concatenate([bs, [tr.end_ns]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    mids = (gap_s + gap_e) // 2
    idle: Dict[str, int] = defaultdict(int)
    order = np.argsort(tr.host_start, kind="stable")
    hs, he = tr.host_start[order], tr.host_end[order]
    names = [tr.host_name[i] for i in order]
    # the innermost operator holding a point starts last among those holding it
    parent = np.full(len(hs), -1, np.int64)
    stack: List[int] = []
    for i in range(len(hs)):
        while stack and he[stack[-1]] < hs[i]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    cand = np.searchsorted(hs, mids, side="right") - 1
    for _ in range(64):
        bad = (cand >= 0) & (he[np.maximum(cand, 0)] < mids)
        if not bad.any():
            break
        cand[bad] = parent[cand[bad]]
    for c, s, e in zip(cand, gap_s, gap_e):
        ok = c >= 0 and he[c] >= (s + e) // 2
        idle["host: " + (short(names[c]) if ok else "no operator")] += int(e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in gaps]}
