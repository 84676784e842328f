"""Auxiliary quality losses on x0-hat (port of
``osmosis_tpu/guidance/losses.py``; reference osmosis_utils/losses.py)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..registry import LOSSES


@LOSSES.register("avrg_loss")
def average_loss(x: torch.Tensor) -> torch.Tensor:
    """Global exposure control: sum of |per-channel spatial mean| over batch
    and RGB channels (losses.py:29-45). NHWC input in [-1, 1].

    |m| is written as sign(m).detach() * m, whose subgradient at m == 0 is 0,
    torch.abs' convention, which the JAX package matches the same way.
    """
    mean = x[..., 0:3].mean(dim=(1, 2))  # [B, 3]
    return (torch.sign(mean).detach() * mean).sum()


@LOSSES.register("val_loss")
def value_loss(x: torch.Tensor, value: float = 0.7) -> torch.Tensor:
    """Penalize RGB magnitudes above ``value`` (losses.py:50-62)."""
    return (torch.clamp(x[..., 0:3].abs() - value, min=0.0) ** 2).mean()


def make_aux_loss_fn(
    losses_dictionary: Optional[Dict[str, float]],
) -> Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]]:
    """Weighted sum of the named losses (AuxiliaryLoss, losses.py:67-83);
    None when the config's aux_loss section is empty."""
    if not losses_dictionary:
        return None
    items = [(k, float(v), LOSSES.get(k)) for k, v in losses_dictionary.items()]

    def aux_fn(x: torch.Tensor):
        total = 0.0
        per = {}
        for name, gamma, fn in items:
            cur = fn(x)
            total = total + gamma * cur
            per[name] = cur
        return total, per

    return aux_fn
