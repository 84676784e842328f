"""device_idle_pct (%, device trace): 100 minus the share of the traced
segments' wall time in which some operation (kernel, copy or fill) ran on
the card."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
