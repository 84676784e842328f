"""gn_roofline_pct (%, device trace): the least time in which the card could
move the bytes of the traced segments' GroupNorm forwards and x-backwards (each input
read once, each output written once, per site from its shape:
``yardstick/unet_cost.gn_bytes``), at the card's published HBM rate, over
the device time of the kernels that implement GroupNorm (names containing
one of ``KERNELS``). None when no such kernel ran."""

from yardstick.unet_cost import gn_bytes

KERNELS = ("gn_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    spent = sum(ctx.trace.device_time_s(k) for k in KERNELS)
    if spent <= 0:
        return None
    o = ctx.outcome
    fwd, bwd = gn_bytes(ctx.arch, o.lanes, 2 if ctx.torso == "bf16" else 4)
    need = (o.trace_steps * fwd + o.trace_x_prev * bwd) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * need / spent
