"""step_mfu_pct (%, device trace over counted FLOP): the FLOP the traced
segments' guided steps need (the UNet forward at every step, the x-only
pullback on x_prev steps, no weight gradients; ``yardstick/unet_cost.flop``
from the UNet's sizes), times the lanes, over the time in which the device
ran some operation during those segments and the dense peak of the torso's
dtype (fp32 with TF32 off, or bf16; the card's published peak,
``yardstick/peaks.json``). The device's idle time is ``device_idle_pct``'s,
not this metric's. None without a trace, a card or a busy device."""

from yardstick.unet_cost import flop


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.outcome.trace_steps:
        return None
    busy = ctx.trace.busy_s()
    if busy <= 0:
        return None
    o = ctx.outcome
    fwd, pull = flop(ctx.arch, o.lanes)
    work = o.trace_steps * fwd + o.trace_x_prev * pull
    peak = ctx.peaks["bf16_flops" if ctx.torso == "bf16" else "fp32_flops"]
    return 100.0 * work / (busy * peak)
