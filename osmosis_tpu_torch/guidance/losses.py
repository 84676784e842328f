"""Auxiliary quality losses on x0-hat (port of
``osmosis_tpu/guidance/losses.py``; reference osmosis_utils/losses.py)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..parallel.mesh import dp_mean, dp_sum
from ..registry import LOSSES


@LOSSES.register("avrg_loss")
def average_loss(x: torch.Tensor, per_lane: bool = False, mesh=None) -> torch.Tensor:
    """Global exposure control: sum of |per-channel spatial mean| over batch
    and RGB channels (losses.py:29-45). NHWC input in [-1, 1]. ``per_lane``
    returns each image's sum, [B], whose total is the batch loss. With a
    ``mesh`` whose dp ranks each hold a slice of the batch, the batch sum
    spans every rank's images (``parallel.mesh.dp_sum``).

    |m| is written as sign(m).detach() * m, whose subgradient at m == 0 is 0,
    torch.abs' convention, which the JAX package matches the same way.
    """
    mean = x[..., 0:3].mean(dim=(1, 2))  # [B, 3]
    per = torch.sign(mean).detach() * mean
    return per.sum(dim=1) if per_lane else dp_sum(per.sum(), mesh)


@LOSSES.register("val_loss")
def value_loss(x: torch.Tensor, value: float = 0.7, per_lane: bool = False,
               mesh=None) -> torch.Tensor:
    """Penalize RGB magnitudes above ``value`` (losses.py:50-62): the mean
    over the batch, or with ``per_lane`` each image's own mean, [B] (the
    loss each image has at batch 1). With a ``mesh`` the mean spans every
    dp rank's images, over the global element count."""
    sq = torch.clamp(x[..., 0:3].abs() - value, min=0.0) ** 2
    return sq.mean(dim=(1, 2, 3)) if per_lane else dp_mean(sq, mesh)


def make_aux_loss_fn(
    losses_dictionary: Optional[Dict[str, float]],
) -> Optional[Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]]:
    """Weighted sum of the named losses (AuxiliaryLoss, losses.py:67-83);
    None when the config's aux_loss section is empty. ``aux_fn(x,
    per_lane=True)`` gives each loss per image ([B]) and their total summed
    over the images; ``aux_fn(x, mesh=mesh)`` each loss over the whole batch
    that the mesh's dp ranks hold between them."""
    if not losses_dictionary:
        return None
    items = [(k, float(v), LOSSES.get(k)) for k, v in losses_dictionary.items()]

    def aux_fn(x: torch.Tensor, per_lane: bool = False, mesh=None):
        total = 0.0
        per = {}
        for name, gamma, fn in items:
            cur = fn(x, per_lane=per_lane, mesh=mesh)
            total = total + gamma * (cur.sum() if per_lane else cur)
            per[name] = cur
        return total, per

    return aux_fn
