"""What a guided step needs of the device, counted from the UNet's sizes:
the FLOP of the forward and of the x-only pullback (matrix products and
convolutions, 2 FLOP a multiply-add, as ``torch.utils.flop_counter``
counts them), and the bytes the GroupNorm sites must move (each input read
once, each output written once: ``tools/gn_bench``'s arithmetic).

The counts depend on the architecture alone, not on how the program
computes it, so a change of implementation leaves them as they are.
"""

from __future__ import annotations

from typing import List, Tuple

from reference.unet import Arch, plan


def _layers(arch: Arch):
    inputs, middle, outputs = plan(arch)
    for block in inputs + [middle] + outputs:
        yield from block


def _res_out(kind: str, res: int) -> int:
    return res // 2 if kind == "down" else res * 2 if kind == "up" else res


def flop(arch: Arch, batch: int = 1) -> Tuple[float, float]:
    """(forward, x-only pullback) FLOP of one UNet call at ``batch``."""
    fwd = bwd = 0.0
    emb = 4 * arch.model_channels
    fwd += 2 * arch.model_channels * emb + 2 * emb * emb  # the time embedding: no pullback
    for kind, cin, cout, res in _layers(arch):
        if kind == "conv_in":
            conv = 2 * cin * cout * 9 * res * res
            fwd, bwd = fwd + conv, bwd + conv
        elif kind == "attn":
            t = res * res
            proj = 2 * cout * 3 * cout * t + 2 * cout * cout * t
            logits = 2 * (2 * t * t * cout)  # q k^T and the weighted sum of v
            fwd += proj + logits
            bwd += proj + 2 * logits  # both operands of each product need gradients
        else:
            r = _res_out(kind, res)
            conv = 2 * cin * cout * 9 * r * r + 2 * cout * cout * 9 * r * r
            if cin != cout:
                conv += 2 * cin * cout * r * r
            fwd += conv + 2 * emb * 2 * cout  # the FiLM projection: no pullback
            bwd += conv
    out = 2 * arch.channel_mult[0] * arch.model_channels * arch.out_channels * 9 * (
        arch.image_size ** 2)
    return batch * (fwd + out), batch * (bwd + out)


def gn_sites(arch: Arch) -> List[Tuple[int, int, bool]]:
    """Each GroupNorm of one forward: (channels, pixels, is the output norm)."""
    sites = []
    for kind, cin, cout, res in _layers(arch):
        if kind == "attn":
            sites.append((cout, res * res, False))
        elif kind != "conv_in":
            sites.append((cin, res * res, False))
            sites.append((cout, _res_out(kind, res) ** 2, False))
    sites.append((arch.channel_mult[0] * arch.model_channels, arch.image_size ** 2, True))
    return sites


def gn_bytes(arch: Arch, batch: int, torso_bytes: int) -> Tuple[float, float]:
    """(forward, backward) bytes of every GroupNorm site of one UNet call:
    the forward reads x and writes y, the x-backward reads x and dy and
    writes dx. Torso sites hold the torso's dtype; the output norm takes
    fp32 (the torso's output is cast before it)."""
    fwd = bwd = 0.0
    for c, px, last in gn_sites(arch):
        n = batch * c * px * (4 if last else torso_bytes)
        fwd += 2 * n
        bwd += 3 * n
    return fwd, bwd
