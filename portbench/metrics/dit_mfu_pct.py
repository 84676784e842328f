"""dit_mfu_pct (%, the program's spans over counted FLOP): the FLOP of pass
C's guided steps in the DiT (the forward at every step, the x-only pullback
at each x_prev step: ``yardstick/dit_cost.flop`` from the DiT's sizes, times
the lanes), over the union of the device intervals of the operations whose
innermost span at launch is the program's ``dit.forward``, ``dit.attention``
or ``guided.pullback`` (of a forward replayed as a CUDA graph, the kernels
the replay launches inside ``dit.forward``), and the dense peak of the
torso's dtype (``yardstick/peaks.json``): the DiT's share of its roofline,
as ``unet_mfu_pct`` is the UNet's. None without a card, without spans in the
program or without such operations (``harness/spans.py``)."""

import numpy as np

from harness.spans import passes
from yardstick.dit_cost import flop

SPANS = ("dit.forward", "dit.attention", "guided.pullback")


def read(ctx):
    if ctx.peaks is None:
        return None
    p = passes(ctx)
    if p is None or not p.device.steps:
        return None
    busy = p.device.busy_s(np.array([s in SPANS for s in p.device.dev_span], bool))
    if busy <= 0:
        return None
    fwd, pull = flop(ctx.arch, ctx.outcome.lanes)
    c = p.device.counts
    work = c["guided.steps"] * fwd + c["guided.x_prev_steps"] * pull
    peak = ctx.peaks["bf16_flops" if ctx.torso == "bf16" else "fp32_flops"]
    return 100.0 * work / (busy * peak)
