"""Checkpoint loading for the port's UNet.

The reference checkpoint is a PyTorch state_dict (``osmosis_outdoor.pt``) whose
names are the port's module names, so it loads with ``load_state_dict`` as it
is. :func:`state_dict_from_jax` carries weights the other way, from the JAX
package's parameter tree (as numpy arrays) into this state_dict: the exact
inverse of ``osmosis_tpu.models.convert.convert_state_dict``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from .unet import UNetConfig, UNetModel, build_plan


def _qkv_permutation(channels: int, num_heads: int, legacy: bool) -> np.ndarray:
    """perm[jax_idx] = torch_idx for the 3C qkv output channels.

    The JAX layout is part-major, idx = part*C + head*hc + c. The reference's
    legacy layout is head-major, idx = head*3*hc + part*hc + c; its new order
    equals the JAX one.
    """
    hc = channels // num_heads
    if not legacy:
        return np.arange(3 * channels)
    part, head, c = np.meshgrid(np.arange(3), np.arange(num_heads), np.arange(hc), indexing="ij")
    perm = np.empty(3 * channels, dtype=np.int64)
    perm[(part * channels + head * hc + c).ravel()] = (head * 3 * hc + part * hc + c).ravel()
    return perm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax(params: Dict[str, Any], cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX UNetModel params (nested dict of numpy arrays, with or without the
    top-level ``"params"`` key) -> this package's UNet state_dict."""
    p = params.get("params", params)
    legacy = not cfg.use_new_attention_order
    sd: Dict[str, torch.Tensor] = {}

    def norm(prefix, leaf):
        sd[f"{prefix}.weight"] = _t(leaf["scale"])
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def conv(prefix, leaf):  # HWIO -> OIHW
        sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def dense(prefix, leaf):  # [in, out] -> [out, in]
        sd[f"{prefix}.weight"] = _t(np.asarray(leaf["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    dense("time_embed.0", p["time_dense0"])
    dense("time_embed.2", p["time_dense1"])

    def layer(lay: dict, prefix: str, name: str):
        kind, leaf = lay["kind"], p[name]
        if kind == "conv_in":
            conv(prefix, leaf)
        elif kind in ("res", "res_down", "res_up"):
            norm(f"{prefix}.in_layers.0", leaf["in_norm"])
            conv(f"{prefix}.in_layers.2", leaf["in_conv"])
            dense(f"{prefix}.emb_layers.1", leaf["emb_proj"])
            norm(f"{prefix}.out_layers.0", leaf["out_norm"])
            conv(f"{prefix}.out_layers.3", leaf["out_conv"])
            if lay["in_ch"] != lay["out_ch"]:
                conv(f"{prefix}.skip_connection", leaf["skip"])
        elif kind == "attn":
            ch = lay["ch"]
            perm = _qkv_permutation(ch, lay["heads"], legacy)
            w = np.empty((3 * ch, ch), np.float32)
            b = np.empty((3 * ch,), np.float32)
            w[perm] = np.asarray(leaf["qkv"]["kernel"]).T
            b[perm] = np.asarray(leaf["qkv"]["bias"])
            norm(f"{prefix}.norm", leaf["norm"])
            sd[f"{prefix}.qkv.weight"] = _t(w[:, :, None])
            sd[f"{prefix}.qkv.bias"] = _t(b)
            sd[f"{prefix}.proj_out.weight"] = _t(np.asarray(leaf["proj"]["kernel"]).T[:, :, None])
            sd[f"{prefix}.proj_out.bias"] = _t(leaf["proj"]["bias"])
        elif kind == "down":
            conv(f"{prefix}.op", leaf["op"])
        elif kind == "up":
            conv(f"{prefix}.conv", leaf["conv"])
        else:
            raise ValueError(kind)

    input_blocks, middle_block, output_blocks = build_plan(cfg)
    for i, block in enumerate(input_blocks):
        for j, lay in enumerate(block):
            layer(lay, f"input_blocks.{i}.{j}", f"in_{i}_{j}")
    for j, lay in enumerate(middle_block):
        layer(lay, f"middle_block.{j}", f"mid_{j}")
    for i, block in enumerate(output_blocks):
        for j, lay in enumerate(block):
            layer(lay, f"output_blocks.{i}.{j}", f"out_{i}_{j}")
    norm("out.0", p["out_norm"])
    conv("out.2", p["out_conv"])
    return sd


def init_unet(cfg: UNetConfig, seed: int = 0) -> UNetModel:
    """A UNet with PyTorch's default init from ``seed`` (output convs zero),
    built on the CPU without touching the global random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return UNetModel(cfg)


def load_unet(model_path: Optional[str], cfg: UNetConfig, device, seed: int = 0) -> UNetModel:
    """Load a reference ``.pt`` state_dict into the port's UNet on ``device``
    in channels_last memory, weights frozen. Falls back to seeded random init
    with the reference's warning (unet.py:94-98) when the file is missing or
    does not load."""
    model = init_unet(cfg, seed)
    try:
        if not (model_path and os.path.exists(model_path)):
            raise FileNotFoundError(model_path)
        model.load_state_dict(torch.load(model_path, map_location="cpu", weights_only=True))
    except (OSError, RuntimeError, pickle.UnpicklingError) as e:
        print(f"Got exception: {e} / Randomly initialize")
    model.requires_grad_(False).eval()
    return model.to(device=device, memory_format=torch.channels_last)
