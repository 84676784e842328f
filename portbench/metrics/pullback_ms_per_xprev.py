"""pullback_ms_per_xprev (ms/x_prev, the program's spans): the host's time in
the program's ``guided.pullback`` spans (the UNet's x-only backward, run on
the autograd engine's thread while the caller waits, and its clip), over
the ``guided.x_prev_steps`` counter, in pass B (``harness/spans.py``). None
where the program has no spans or pulled back at no step."""

from harness.spans import passes


def read(ctx):
    p = passes(ctx)
    if p is None or not p.host.counts["guided.x_prev_steps"]:
        return None
    return 1e3 * p.host.total_s("guided.pullback") / p.host.counts["guided.x_prev_steps"]
