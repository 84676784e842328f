"""Physical image-formation operators with learnable water parameters (port
of ``osmosis_tpu/guidance/operators.py``; reference guided_diffusion/
measurements.py).

Each operator is ``forward(phi, rgbd) -> degraded RGB in [0, 1]`` on NHWC
tensors, plus host-side metadata: phi inits, per-phi learning rates and the
optimizer's name. phi is a dict of [B, C] float32 tensors.

Formation model (measurements.py:251-264):
    I = J * exp(-phi_a * z) + phi_inf * (1 - exp(-phi_b * z))
with J = (rgb + 1) / 2 and z = convert_depth(depth).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..config import get_depth_value, parse_phi
from ..registry import OPERATORS


def convert_depth(depth: torch.Tensor, depth_type: str, value: Any) -> torch.Tensor:
    """UNet depth channel -> physical depth (utils.py:544-566).

    depth_type 'gamma' with value (a, b, g): ((d + a) * b) ** g;
    'original' / None: 0.5 * (d + 1); 'move': d + value.
    """
    if depth_type == "move":
        return depth + value
    if depth_type == "gamma":
        return torch.pow((depth + float(value[0])) * float(value[1]), float(value[2]))
    if depth_type is None or depth_type == "original":
        return 0.5 * (depth + 1.0)
    raise NotImplementedError(f"depth_type {depth_type!r}")


def split_rgbd(data: torch.Tensor):
    """NHWC RGBD -> (rgb in [-1, 1], depth [B, H, W, 1])."""
    return data[..., 0:-1], data[..., -1:]


@dataclasses.dataclass(frozen=True)
class Operator:
    """Base: identity A(x) = x (DenoiseOperator / RGBGuidanceOperator)."""

    name: str
    batch_size: int = 1
    optimizer: str = "sgd"
    depth_type: str = None
    depth_value: Any = None

    def phi_init(self) -> Dict[str, np.ndarray]:
        return {}

    def etas(self) -> Dict[str, Any]:
        return {}

    def forward(self, phi: Dict[str, torch.Tensor], data: torch.Tensor) -> torch.Tensor:
        return data

    def _prep(self, data):
        rgb, depth = split_rgbd(data)
        return 0.5 * (rgb + 1.0), convert_depth(depth, self.depth_type, self.depth_value)

    @staticmethod
    def _bc(phi_entry: torch.Tensor) -> torch.Tensor:
        """[B, C] -> [B, 1, 1, C]."""
        return phi_entry[:, None, None, :]


@OPERATORS.register("noise")
@dataclasses.dataclass(frozen=True)
class DenoiseOperator(Operator):
    pass


@OPERATORS.register("rgb_guidance")
@dataclasses.dataclass(frozen=True)
class RGBGuidanceOperator(Operator):
    pass


def _parse_eta(eta):
    """Scalar eta, or a per-channel [C] array from a comma list / sequence."""
    if isinstance(eta, str) and "," in eta:
        return np.asarray([float(x) for x in eta.split(",")], np.float32)
    if isinstance(eta, (list, tuple)):
        return np.asarray([float(x) for x in eta], np.float32)
    return float(eta)


@dataclasses.dataclass(frozen=True)
class PhysicsOperator(Operator):
    """Shared phi bookkeeping for the three learnable operators."""

    phi_specs: tuple = ()  # ((name, init_spec, eta, learn_flag), ...)

    def phi_init(self) -> Dict[str, np.ndarray]:
        return {name: parse_phi(init, self.batch_size) for name, init, _, _ in self.phi_specs}

    def etas(self) -> Dict[str, Any]:
        # eta is zeroed when the learn flag is off (measurements.py:239-242)
        return {name: (_parse_eta(eta) if learn else 0.0) for name, _, eta, learn in self.phi_specs}


@OPERATORS.register("underwater_physical_revised")
@dataclasses.dataclass(frozen=True)
class UnderWaterPhysicalRevisedOperator(PhysicsOperator):
    """Separate attenuation / backscatter coefficients (measurements.py:211-329)."""

    def forward(self, phi, data):
        rgb01, z = self._prep(data)
        att = torch.exp(-self._bc(phi["phi_a"]) * z)
        bsc = 1.0 - torch.exp(-self._bc(phi["phi_b"]) * z)
        return rgb01 * att + self._bc(phi["phi_inf"]) * bsc


@OPERATORS.register("underwater_physical")
@dataclasses.dataclass(frozen=True)
class UnderWaterPhysicalOperator(PhysicsOperator):
    """Shared phi_ab for attenuation and backscatter (measurements.py:332-433)."""

    def forward(self, phi, data):
        rgb01, z = self._prep(data)
        e = torch.exp(-self._bc(phi["phi_ab"]) * z)
        return rgb01 * e + self._bc(phi["phi_inf"]) * (1.0 - e)


@OPERATORS.register("haze_physical")
@dataclasses.dataclass(frozen=True)
class HazePhysicalOperator(PhysicsOperator):
    """Scalar phi_ab haze model (measurements.py:107-208)."""

    def forward(self, phi, data):
        rgb01, z = self._prep(data)
        e = torch.exp(-self._bc(phi["phi_ab"]) * z)
        return rgb01 * e + self._bc(phi["phi_inf"]) * (1.0 - e)


def get_operator(name: str, batch_size: int = 1, **kwargs) -> Operator:
    """Factory from the YAML operator section (measurements.py:30-38)."""
    cls = OPERATORS.get(name)
    depth_type = kwargs.get("depth_type")
    depth_value = get_depth_value(kwargs.get("value")) if "value" in kwargs else None
    optimizer = kwargs.get("optimizer", "sgd") or "sgd"

    def spec(pname):
        return (pname, kwargs[pname], kwargs.get(f"{pname}_eta", 1e-5),
                kwargs.get(f"{pname}_learn_flag", True))

    if name == "underwater_physical_revised":
        phi_specs = (spec("phi_a"), spec("phi_b"), spec("phi_inf"))
    elif name in ("underwater_physical", "haze_physical"):
        phi_specs = (spec("phi_ab"), spec("phi_inf"))
    else:
        return cls(name=name, batch_size=batch_size)
    return cls(name=name, batch_size=batch_size, optimizer=optimizer, depth_type=depth_type,
               depth_value=depth_value, phi_specs=phi_specs)
