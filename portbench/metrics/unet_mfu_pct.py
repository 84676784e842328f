"""unet_mfu_pct (%, the program's spans over counted FLOP): the FLOP of pass
C's guided steps in the UNet (the forward at every step, the x-only
pullback at each x_prev step: ``yardstick/unet_cost.flop`` from the UNet's
sizes, times the lanes), over the union of the device intervals of the
operations launched inside the program's ``unet.forward`` or
``guided.pullback`` spans and the dense peak of the torso's dtype
(``yardstick/peaks.json``). Unlike ``step_mfu_pct`` it leaves out the phi
loop's and the posterior's small operations. None without a card, without
spans in the program or without such operations (``harness/spans.py``)."""

from harness.spans import passes
from yardstick.unet_cost import flop


def read(ctx):
    if ctx.peaks is None:
        return None
    p = passes(ctx)
    if p is None or not p.device.steps:
        return None
    busy = p.device.busy_s(p.device.dev_unet)
    if busy <= 0:
        return None
    fwd, pull = flop(ctx.arch, ctx.outcome.lanes)
    c = p.device.counts
    work = c["guided.steps"] * fwd + c["guided.x_prev_steps"] * pull
    peak = ctx.peaks["bf16_flops" if ctx.torso == "bf16" else "fp32_flops"]
    return 100.0 * work / (busy * peak)
