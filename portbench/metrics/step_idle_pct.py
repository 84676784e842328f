"""step_idle_pct (%, the program's spans and counters): the device's idle
share of a guided step without the profiler's cost to the host: 100 x (1 -
B / W), B the union of the device's operations in pass C (spans on, under
the profiler) over its ``guided.steps``, W the wall time of pass B's
synchronized segments (spans on, no profiler) over its ``guided.steps``
(``harness/spans.py``). None where the program has no spans."""

from harness.spans import passes


def read(ctx):
    p = passes(ctx)
    if p is None or not p.host.steps or not p.device.steps:
        return None
    busy = p.device.busy_s() / p.device.steps
    wall = sum(p.host.wall_s) / p.host.steps
    return 100.0 * (1.0 - busy / wall)
