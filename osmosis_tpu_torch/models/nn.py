"""NN primitives of the ADM UNet (port of ``osmosis_tpu/models/nn.py``).

Behavioural contracts kept from the JAX package:
  * GroupNorm32: 32 groups, eps 1e-5, fp32 statistics, result cast back;
    the SiLU and the FiLM epilogue are fused into the norm's op
    (:func:`osmosis_tpu_torch.ops.group_norm.group_norm_act`, kernels K3/K4);
  * the sinusoidal timestep embedding, cos first.

Tensors are NCHW in ``channels_last`` memory. The JAX package's strip
representation and its dot-product convolutions are TPU layout devices; here
a 3x3 'same' conv is a plain ``nn.Conv2d``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.group_norm import group_norm_act
from ..ops.upsample import avg_pool_2x as _avg_pool_nhwc
from ..ops.upsample import upsample_nearest_2x as _upsample_nhwc


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, [N] -> [N, dim], cos first."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm(32, C) with fp32 statistics, result in the input's dtype.

    Parameters are ``weight`` and ``bias`` like ``torch.nn.GroupNorm``, so a
    reference state_dict loads as it is. ``film=(scale, shift)`` ([B, C] each)
    applies ``h·(1+scale)+shift`` and ``act='silu'`` the SiLU, both inside the
    fused op, as ``GroupNorm32.__call__`` dispatches in the JAX package.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                act: Optional[str] = None) -> torch.Tensor:
        return group_norm_act(x, self.weight.float(), self.bias.float(), film=film, act=act)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW channels_last tensor (kernel K1/K2)."""
    x = x.contiguous(memory_format=torch.channels_last)
    return _upsample_nhwc(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of an NCHW channels_last tensor (kernel K2/K1)."""
    x = x.contiguous(memory_format=torch.channels_last)
    return _avg_pool_nhwc(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def zero_module(module: nn.Module) -> nn.Module:
    """Zero a module's parameters (the reference's zero-initialized output convs)."""
    for p in module.parameters():
        nn.init.zeros_(p)
    return module
