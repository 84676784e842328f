"""dit_attn_mfu_pct (%, the program's spans over counted FLOP): the FLOP of
the attention products under pass C's ``dit.attention`` spans (each block's
``scaled_dot_product_attention`` call alone, in the forwards that run
eagerly: ``yardstick/dit_cost.attn_flop`` of a forward at the lanes, over
its ``depth`` blocks, a span), over the union of the device intervals of the
operations whose innermost span at launch is ``dit.attention``, and the
dense peak of the torso's dtype: the attention's share of its roofline. A
forward replayed as a CUDA graph has no such span, and its attention is
counted in neither. None without a card, without spans in the program or
without such operations."""

import numpy as np

from harness.spans import passes
from yardstick.dit_cost import attn_flop


def read(ctx):
    if ctx.peaks is None:
        return None
    p = passes(ctx)
    if p is None or not p.device.steps:
        return None
    busy = p.device.busy_s(np.array([s == "dit.attention" for s in p.device.dev_span], bool))
    if busy <= 0:
        return None
    calls = sum(n == "dit.attention" for n in p.device.span_name)
    work = calls * attn_flop(ctx.arch, ctx.outcome.lanes) / ctx.arch.depth
    peak = ctx.peaks["bf16_flops" if ctx.torso == "bf16" else "fp32_flops"]
    return 100.0 * work / (busy * peak)
