"""What a guided step needs of the device in a DiT, counted from its sizes:
the FLOP of the forward and of the x-only pullback, 2 FLOP a multiply-add,
as ``torch.utils.flop_counter`` counts them.

The forward: the patch embedding, the timestep MLP, each block's adaLN
projection, qkv, output projection and MLP, the two attention products
(q k^T and the weighted sum of v), and the final layer's adaLN projection
and linear. The pullback to x: every product on x's path once (the gradient
of its input; the weights are frozen), the attention's four (dQ, dK, dV and
dP, both operands of each forward product depending on x), and nothing of
the conditioning, which does not depend on x.

The counts depend on the architecture alone, not on how the program
computes it, so a change of implementation leaves them as they are.
"""

from __future__ import annotations

from typing import Tuple


def _parts(s) -> Tuple[float, float, float, float]:
    """(conditioning, patch embedding and final linear, the blocks' dense
    products, the blocks' attention products) of one forward at batch 1."""
    t, h, m = s.tokens, s.hidden_size, s.mlp_hidden
    pp = s.patch_size ** 2
    cond = 2 * s.frequency_embedding_size * h + 2 * h * h + s.depth * 2 * h * 6 * h + 2 * h * 2 * h
    io = 2 * t * s.in_channels * pp * h + 2 * t * h * s.out_channels * pp
    dense = s.depth * (2 * t * h * 3 * h + 2 * t * h * h + 2 * 2 * t * h * m)
    attn = s.depth * 2 * (2 * t * t * h)
    return cond, io, dense, attn


def flop(s, batch: int = 1) -> Tuple[float, float]:
    """(forward, x-only pullback) FLOP of one DiT call at ``batch``."""
    cond, io, dense, attn = _parts(s)
    return batch * (cond + io + dense + attn), batch * (io + dense + 2 * attn)


def attn_flop(s, batch: int = 1) -> float:
    """The FLOP of a forward's attention products (q k^T and the weighted
    sum of v, every block) at ``batch``."""
    return batch * _parts(s)[3]
