"""Measurement noise models (port of ``osmosis_tpu/guidance/noise.py``;
reference guided_diffusion/measurements.py:462-529). The draws come from an
explicit ``torch.Generator``; their bits differ from ``jax.random``'s."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..registry import NOISES


@dataclasses.dataclass(frozen=True)
class Noiser:
    name: str

    def __call__(self, data: torch.Tensor, generator: Optional[torch.Generator] = None):
        raise NotImplementedError


@NOISES.register("clean")
@dataclasses.dataclass(frozen=True)
class Clean(Noiser):
    def __call__(self, data, generator=None):
        return data


@NOISES.register("gaussian")
@dataclasses.dataclass(frozen=True)
class GaussianNoise(Noiser):
    sigma: float = 0.0

    def __call__(self, data, generator=None):
        if self.sigma == 0:
            return data
        z = torch.randn(data.shape, generator=generator, dtype=data.dtype, device=data.device)
        return data + z * self.sigma


def get_noiser(name: str, **kwargs) -> Noiser:
    """The port has the 'clean' and 'gaussian' models; 'poisson' is not ported."""
    cls = NOISES.get(name)
    if name == "gaussian":
        return cls(name=name, sigma=float(kwargs.get("sigma", 0.0)))
    return cls(name=name)
