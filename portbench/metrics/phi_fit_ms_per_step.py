"""phi_fit_ms_per_step (ms/step, the program's spans): the host's time in
the program's ``guided.phi_fit`` spans (each step's phi warm phase and
phi-only iterations, launched eagerly), over the ``guided.steps`` counter,
in pass B: segments after the window with the spans on and no profiler
(``harness/spans.py``). None where the program has no spans."""

from harness.spans import passes


def read(ctx):
    p = passes(ctx)
    if p is None or not p.host.steps:
        return None
    return 1e3 * p.host.total_s("guided.phi_fit") / p.host.steps
