"""The host around the window: what the machine's CPUs and this process did
in each segment, read from ``/proc`` (Linux) and the process's CPU clock.
Facts for the run's earlier lines, not metrics: they tell a slow segment
that the host held back (stolen or contended CPU time, a lower clock) from
one that did more work."""

from __future__ import annotations

import time
from typing import List, Optional, Tuple


def _cpu_jiffies() -> Optional[Tuple[int, int, int]]:
    """(busy, steal, total) jiffies of all CPUs since boot, or None."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None
    user, nice, system, idle, iowait, irq, softirq, steal = v + [0] * (8 - len(v))
    return user + nice + system + irq + softirq, steal, sum(v)


def cpu_mhz() -> Optional[float]:
    """The mean clock of the machine's CPUs as the kernel reports it."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


def load_1min() -> Optional[float]:
    try:
        with open("/proc/loadavg") as f:
            return float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


class Sampler:
    """``mark()`` at each segment boundary; ``rows()`` gives per segment the
    machine's busy and stolen share of all its CPUs' time and this process's
    CPU time over the segment's wall time, in percent."""

    def __init__(self):
        self.marks: List[tuple] = []
        self.mark()

    def mark(self):
        self.marks.append((time.perf_counter(), time.process_time(), _cpu_jiffies()))

    def rows(self) -> List[Tuple[Optional[float], Optional[float], float]]:
        out = []
        for (w0, p0, j0), (w1, p1, j1) in zip(self.marks, self.marks[1:]):
            busy = steal = None
            if j0 and j1 and j1[2] > j0[2]:
                total = j1[2] - j0[2]
                busy = round(100.0 * (j1[0] - j0[0]) / total, 1)
                steal = round(100.0 * (j1[1] - j0[1]) / total, 1)
            out.append((busy, steal, round(100.0 * (p1 - p0) / max(w1 - w0, 1e-9), 1)))
        return out
