"""The model of a preset: its ``unet_model`` section (the ADM UNet,
``models/unet``) or its ``dit_model`` section (DiT, ``models/dit``), read,
built, loaded, cast and frozen in one place for every entry point that runs
a preset (``pipelines/restore``, ``pipelines/prior``, ``tools/serve``).

A ``dit_model`` section has the keys ``image_size``, ``patch_size``,
``hidden_size``, ``depth``, ``num_heads``, ``mlp_ratio``,
``frequency_embedding_size``, ``in_channels``, ``learn_sigma``,
``use_fp16`` and ``model_path``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from .convert import load_unet
from .dit import dit_config_from_yaml, load_dit
from .unet import unet_config_from_yaml

SECTIONS = ("unet_model", "dit_model")
NORMS = {"unet_model": "GroupNorm", "dit_model": "LayerNorm"}


def model_section(args) -> Tuple[str, Dict[str, Any]]:
    """(the section's name, its settings) of the preset ``args`` (the
    namespace of ``config.arguments_from_file``), which holds one of
    :data:`SECTIONS`."""
    found = [(k, getattr(args, k)) for k in SECTIONS if getattr(args, k, None) is not None]
    if len(found) != 1:
        raise ValueError(f"a preset holds exactly one model section of {SECTIONS}, "
                         f"this one {[k for k, _ in found]}")
    return found[0]


def model_settings(args) -> Dict[str, Any]:
    """The preset's model section (``image_size``, ``use_fp16``,
    ``model_path``, ...)."""
    return model_section(args)[1]


def norm_name(args) -> str:
    """The norm whose statistics a bf16 torso keeps in fp32."""
    return NORMS[model_section(args)[0]]


def load_model(args, device, dtype: torch.dtype = torch.float32, seed: int = 0) -> nn.Module:
    """The preset's model on ``device`` with its torso in ``dtype``, frozen:
    the UNet through ``convert.load_unet`` (every preset with a
    ``unet_model`` builds what it built before), or the DiT through
    ``dit.load_dit``, each from its section's ``model_path`` or, where no
    checkpoint is there, its seeded init."""
    kind, section = model_section(args)
    path = section.get("model_path", "")
    if kind == "dit_model":
        return load_dit(path, dit_config_from_yaml(section), device, seed=seed, dtype=dtype)
    return load_unet(path, unet_config_from_yaml(section), device, seed=seed, dtype=dtype)
