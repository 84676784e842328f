"""Functional per-phi optimizers for the water-parameter updates (port of
``osmosis_tpu/guidance/phi_optim.py``).

Each optimizer is an (init, update) pair of pure functions on dicts of
tensors, with torch-default hyperparameters: ``update(phi, grads, state)``
returns ``(new_phi, new_state)`` and changes none of its inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

PhiTree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PhiOptimizer:
    init: Callable[[PhiTree], dict]
    update: Callable[[PhiTree, PhiTree, dict], Tuple[PhiTree, dict]]


def _eta(etas, k, like: torch.Tensor):
    """A scalar eta, or a per-channel [C] eta as a tensor beside ``like``."""
    e = etas[k]
    return e if isinstance(e, float) else torch.as_tensor(e, dtype=like.dtype, device=like.device)


def make_phi_optimizer(name: str, etas: Dict[str, float]) -> PhiOptimizer:
    name = (name or "gd").lower()

    if name in ("", "gd", "sgd"):
        # torch.optim.SGD without momentum == manual GD (measurements.py:279-301)
        def init(phi):
            return {}

        def update(phi, grads, state):
            return {k: phi[k] - _eta(etas, k, phi[k]) * grads[k] for k in phi}, state

        return PhiOptimizer(init, update)

    if name == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8  # torch.optim.Adam defaults

        def init(phi):
            return {
                "m": {k: torch.zeros_like(v) for k, v in phi.items()},
                "v": {k: torch.zeros_like(v) for k, v in phi.items()},
                "count": 0,
            }

        def update(phi, grads, state):
            count = state["count"] + 1
            # bias corrections in fp32, as the JAX package computes them
            t = np.float32(count)
            bc1 = np.float32(1) - np.float32(b1) ** t
            bc2 = np.float32(1) - np.float32(b2) ** t
            new_phi, new_m, new_v = {}, {}, {}
            for k in phi:
                m = b1 * state["m"][k] + (1 - b1) * grads[k]
                v = b2 * state["v"][k] + (1 - b2) * grads[k] ** 2
                mhat = m / float(bc1)
                vhat = v / float(bc2)
                new_phi[k] = phi[k] - _eta(etas, k, phi[k]) * mhat / (torch.sqrt(vhat) + eps)
                new_m[k], new_v[k] = m, v
            return new_phi, {"m": new_m, "v": new_v, "count": count}

        return PhiOptimizer(init, update)

    if name == "rmsprop":
        alpha, eps = 0.99, 1e-8  # torch.optim.RMSprop defaults

        def init(phi):
            return {"sq": {k: torch.zeros_like(v) for k, v in phi.items()}}

        def update(phi, grads, state):
            new_phi, new_sq = {}, {}
            for k in phi:
                sq = alpha * state["sq"][k] + (1 - alpha) * grads[k] ** 2
                new_phi[k] = phi[k] - _eta(etas, k, phi[k]) * grads[k] / (torch.sqrt(sq) + eps)
                new_sq[k] = sq
            return new_phi, {"sq": new_sq}

        return PhiOptimizer(init, update)

    raise ValueError(f"phi optimizer '{name}' is not supported")
