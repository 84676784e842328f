"""The ADM UNet (guided-diffusion's, as the Osmosis checkpoint configures
it): everything the harness needs to know of a configuration whose model
is this UNet. A configuration without a ``family`` key is of this family.

Its sizes are the preset's ``unet_model`` section (``reference.unet.Arch``);
the program's model is the port's ``UNetModel`` from
``unet_config_from_yaml``, built and laid out as ``run_restoration`` builds
it; the reference is ``reference.unet.UNet``; the FLOP a step takes are
``yardstick/unet_cost.flop``.
"""

from __future__ import annotations

import dataclasses

import torch

from harness import weights
from osmosis_tpu_torch.models.convert import cast_params_half
from osmosis_tpu_torch.models.unet import UNetModel, unet_config_from_yaml
from reference.unet import Arch, UNet
from yardstick import unet_cost

ZERO_INIT = ("out_layers.3.", "proj_out.", "out.2.")
NORMS = ("in_layers.0.", "out_layers.0.", "norm.", "out.0.")
SIZES = ("image_size", "model_channels", "num_res_blocks", "channel_mult", "num_head_channels")
flop = unet_cost.flop  # (forward, x-only pullback) FLOP of a call at a batch


def leaf_kind(name: str) -> str:
    """The weight rule (``harness/weights.py``): GroupNorm weights 1; the
    zero-initialized output convolutions of each ResBlock, attention block
    and of the model, and the GroupNorm biases, 0.02 N(0, 1); the rest
    PyTorch's default."""
    if any(z in name for z in ZERO_INIT):
        return "normal"
    if any(n in name for n in NORMS):
        return "ones" if name.endswith("weight") else "normal"
    return "uniform"


def sizes(config: dict, overrides: dict) -> Arch:
    """The UNet's sizes from the preset's ``unet_model``, with the tests'
    smaller ones (``attention_resolutions`` as image sizes)."""
    arch = Arch.from_preset(config["preset"]["unet_model"], **{
        k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items() if k in SIZES})
    if "attention_resolutions" in overrides:
        arch = dataclasses.replace(arch, attention_ds=tuple(
            arch.image_size // r for r in overrides["attention_resolutions"]))
    return arch


def torso_dtype(config: dict) -> torch.dtype:
    return torch.bfloat16 if config["preset"]["unet_model"].get("use_fp16") else torch.float32


def _port_overrides(arch: Arch, overrides: dict) -> dict:
    """The same sizes for the port's ``unet_config_from_yaml``."""
    o = dict(overrides)
    if "attention_resolutions" in o:
        o["attention_resolutions"] = tuple(arch.image_size // r for r in o["attention_resolutions"])
    if "channel_mult" in o:
        o["channel_mult"] = tuple(o["channel_mult"])
    return o


def program(config: dict, arch: Arch, overrides: dict, seed: int, device) -> torch.nn.Module:
    """The port's UNet, built on ``device`` and filled with the seeded
    weights before its bf16 cast (``cast_params_half`` where the preset sets
    ``use_fp16``), frozen and channels_last."""
    dtype = torso_dtype(config)
    cfg = unet_config_from_yaml(config["preset"]["unet_model"], **_port_overrides(arch, overrides))
    with torch.device(device):
        model = UNetModel(dataclasses.replace(cfg, dtype=dtype))
    weights.fill(model, seed, leaf_kind)
    if dtype != torch.float32:
        cast_params_half(model, dtype)
    model.requires_grad_(False).eval()
    return model.to(memory_format=torch.channels_last)


def reference(arch: Arch, seed: int, device) -> UNet:
    """The plain fp32 UNet filled with the program's bits; ``set_quant``
    rounds its products' operands for the control."""
    with torch.device(device):
        ref = UNet(arch)
    return weights.fill(ref, seed, leaf_kind).requires_grad_(False).eval()
