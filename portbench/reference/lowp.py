"""Rounding of a matrix product's operands to a lower precision than the
configuration states: the controls that the comparison has to refuse.

* :func:`fp8` (below bf16): each tensor scaled by its largest magnitude onto
  float8 e4m3's range (448), rounded to e4m3 and scaled back, as fp8
  inference with per-tensor scales computes;
  both pass gradients through unchanged, so a pullback multiplies by the
  rounded operands that the forward saved.
* :func:`tf32` (below fp32 with TF32 off): the mantissa rounded to TF32's 10
  bits (round to nearest even), what a TF32 tensor-core product takes as
  its inputs; on a card the program's own TF32 switch serves instead.
"""

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return t + (bits.view(torch.float32) - t).detach()
