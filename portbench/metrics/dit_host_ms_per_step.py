"""dit_host_ms_per_step (ms/step, the program's spans): the host's time in
the program's ``dit.forward`` spans (the DiT's launches, or its wait for
room in the launch queue where the device sets the pace), over the
``guided.steps`` counter, in pass B (``harness/spans.py``). None off the
card and where the program has no spans."""

from harness.spans import passes


def read(ctx):
    if ctx.peaks is None:
        return None
    p = passes(ctx)
    if p is None or not p.host.steps:
        return None
    return 1e3 * p.host.total_s("dit.forward") / p.host.steps
