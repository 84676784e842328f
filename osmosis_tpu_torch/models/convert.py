"""Checkpoints of the port's UNet, in both packages' formats.

The reference checkpoint is a PyTorch state_dict (``osmosis_outdoor.pt``) whose
names are the port's module names, so it loads with ``load_state_dict`` as it
is. The JAX package keeps a parameter tree (``{"params": {...}}``, conv kernels
HWIO, dense kernels ``[in, out]``, the qkv channels part-major) and saves it as
flax msgpack. :func:`state_dict_from_jax` carries such a tree into this
state_dict and :func:`params_from_state_dict` carries it back (the port's copy
of ``osmosis_tpu.models.convert.convert_state_dict``); each is the other's
exact inverse. :func:`save_params_msgpack` and :func:`load_params_msgpack` read
and write the JAX package's ``.msgpack`` files through the port's own msgpack
codec (``utils/msgpack.py``), so the two packages read each other's
checkpoints, and :func:`unet_from_msgpack` builds a UNet from such a file.
:func:`cast_params_half` is the counterpart of the JAX package's
``cast_params_half``: the bf16 torso's weights.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import msgpack
from .nn import GroupNorm32
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


def _np(a) -> np.ndarray:
    """A leaf (numpy array, or tensor of any float dtype) as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a), dtype=np.float32))


def state_dict_from_jax(params: Dict[str, Any], cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX UNetModel params (nested dict of numpy arrays or tensors, with or
    without the top-level ``"params"`` key) -> this package's UNet state_dict,
    fp32 on the CPU."""
    p = params.get("params", params)
    legacy = not cfg.use_new_attention_order
    sd: Dict[str, torch.Tensor] = {}

    def norm(prefix, leaf):
        sd[f"{prefix}.weight"] = _t(leaf["scale"])
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def conv(prefix, leaf):  # HWIO -> OIHW
        sd[f"{prefix}.weight"] = _t(np.transpose(_np(leaf["kernel"]), (3, 2, 0, 1)))
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def dense(prefix, leaf):  # [in, out] -> [out, in]
        sd[f"{prefix}.weight"] = _t(_np(leaf["kernel"]).T)
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
            w[perm] = _np(leaf["qkv"]["kernel"]).T
            b[perm] = _np(leaf["qkv"]["bias"])
            norm(f"{prefix}.norm", leaf["norm"])
            sd[f"{prefix}.qkv.weight"] = _t(w[:, :, None])
            sd[f"{prefix}.qkv.bias"] = _t(b)
            sd[f"{prefix}.proj_out.weight"] = _t(_np(leaf["proj"]["kernel"]).T[:, :, None])
            sd[f"{prefix}.proj_out.bias"] = _t(leaf["proj"]["bias"])
        elif kind == "down":
            conv(f"{prefix}.op", leaf["op"])
        elif kind == "up":
            conv(f"{prefix}.conv", leaf["conv"])
        else:
            raise ValueError(kind)

    _walk_plan(cfg, layer)
    norm("out.0", p["out_norm"])
    conv("out.2", p["out_conv"])
    return sd


def _walk_plan(cfg: UNetConfig, visit) -> None:
    """``visit(layer, torch_prefix, jax_name)`` for every layer of the plan."""
    input_blocks, middle_block, output_blocks = build_plan(cfg)
    for i, block in enumerate(input_blocks):
        for j, lay in enumerate(block):
            visit(lay, f"input_blocks.{i}.{j}", f"in_{i}_{j}")
    for j, lay in enumerate(middle_block):
        visit(lay, f"middle_block.{j}", f"mid_{j}")
    for i, block in enumerate(output_blocks):
        for j, lay in enumerate(block):
            visit(lay, f"output_blocks.{i}.{j}", f"out_{i}_{j}")


def params_from_state_dict(sd: Dict[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """This package's UNet state_dict (tensors or numpy arrays) -> the JAX
    UNetModel's ``{"params": {...}}`` tree of fp32 numpy arrays: the port's copy
    of ``osmosis_tpu.models.convert.convert_state_dict`` (:99-137), conv
    kernels OIHW -> HWIO, linear weights transposed, the legacy qkv channels
    permuted to part-major. The exact inverse of :func:`state_dict_from_jax`."""
    sd = {k: _np(v) for k, v in sd.items()}
    legacy = not cfg.use_new_attention_order

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def conv(prefix):  # OIHW -> HWIO
        return {"kernel": np.ascontiguousarray(np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))),
                "bias": sd[f"{prefix}.bias"]}

    def dense(prefix):  # [out, in] -> [in, out]
        return {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
                "bias": sd[f"{prefix}.bias"]}

    params: Dict[str, Any] = {
        "time_dense0": dense("time_embed.0"),
        "time_dense1": dense("time_embed.2"),
        "out_norm": norm("out.0"),
        "out_conv": conv("out.2"),
    }

    def layer(lay: dict, prefix: str, name: str):
        kind = lay["kind"]
        if kind == "conv_in":
            params[name] = conv(prefix)
        elif kind in ("res", "res_down", "res_up"):
            params[name] = {
                "in_norm": norm(f"{prefix}.in_layers.0"),
                "in_conv": conv(f"{prefix}.in_layers.2"),
                "emb_proj": dense(f"{prefix}.emb_layers.1"),
                "out_norm": norm(f"{prefix}.out_layers.0"),
                "out_conv": conv(f"{prefix}.out_layers.3"),
            }
            if lay["in_ch"] != lay["out_ch"]:
                params[name]["skip"] = conv(f"{prefix}.skip_connection")
        elif kind == "attn":
            perm = _qkv_permutation(lay["ch"], lay["heads"], legacy)
            qkv_w = sd[f"{prefix}.qkv.weight"][:, :, 0]  # [3C, C]
            params[name] = {
                "norm": norm(f"{prefix}.norm"),
                "qkv": {"kernel": np.ascontiguousarray(qkv_w[perm].T),
                        "bias": sd[f"{prefix}.qkv.bias"][perm]},
                "proj": {"kernel": np.ascontiguousarray(sd[f"{prefix}.proj_out.weight"][:, :, 0].T),
                         "bias": sd[f"{prefix}.proj_out.bias"]},
            }
        elif kind == "down":
            params[name] = {"op": conv(f"{prefix}.op")}
        elif kind == "up":
            params[name] = {"conv": conv(f"{prefix}.conv")}
        else:
            raise ValueError(kind)

    _walk_plan(cfg, layer)
    return {"params": params}


def save_params_msgpack(params: Dict[str, Any], path: str) -> None:
    """Write a parameter tree as the JAX package's ``save_params_msgpack``
    does (flax msgpack, the same bytes)."""
    with open(path, "wb") as f:
        msgpack.dump(params, f.write)


def load_params_msgpack(path: str) -> Dict[str, Any]:
    """Read a ``.msgpack`` parameter tree (the JAX package's
    ``load_params_msgpack``): numpy arrays, bfloat16 leaves as tensors."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def is_orbax_checkpoint(path: Optional[str]) -> bool:
    """The JAX loader's test for an orbax checkpoint directory."""
    return bool(path) and (path.endswith(".orbax") or (
        os.path.isdir(os.path.join(path, ""))
        and os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))))


def init_unet(cfg: UNetConfig, seed: int = 0) -> UNetModel:
    """A UNet with PyTorch's default init from ``seed`` (output convs zero),
    built on the CPU without touching the global random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return UNetModel(cfg)


def cast_params_half(model: UNetModel, dtype: torch.dtype = torch.bfloat16) -> UNetModel:
    """Cast every parameter to ``dtype`` in place, except the GroupNorm
    weights and biases, which stay fp32 (``osmosis_tpu.models.convert.
    cast_params_half`` without its ``gn_affine_bf16`` knob). The output conv
    is cast too: its weights are rounded to ``dtype`` and the model computes
    it in fp32, as the JAX model does."""
    for module in model.modules():
        if isinstance(module, GroupNorm32):
            continue
        for p in module.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return model


class CheckpointMismatch(RuntimeError):
    """A checkpoint that reads but does not fit the UNet's config."""


def unet_from_msgpack(path: str, cfg: UNetConfig, seed: int = 0) -> UNetModel:
    """A UNet on the CPU, fp32 and trainable, holding the weights of a
    ``.msgpack`` parameter tree (carried over by :func:`state_dict_from_jax`).
    A missing or unreadable file raises; a tree that does not fit ``cfg``
    raises :class:`CheckpointMismatch`, as the JAX model would when it
    applies it."""
    params = load_params_msgpack(path)
    model = init_unet(cfg, seed)
    try:
        model.load_state_dict(state_dict_from_jax(params, cfg))
    except (KeyError, ValueError, RuntimeError) as e:
        raise CheckpointMismatch(f"{path} does not fit the UNet config: {e!r}") from e
    return model


def load_unet(model_path: Optional[str], cfg: UNetConfig, device, seed: int = 0,
              dtype: Optional[torch.dtype] = None) -> UNetModel:
    """Load a checkpoint into the port's UNet on ``device`` in channels_last
    memory, weights frozen: what the JAX package's ``load_unet_params``
    (:203-227) accepts.

    * ``.msgpack``: :func:`unet_from_msgpack`; a tree that does not fit
      ``cfg`` raises;
    * an orbax directory raises ``NotImplementedError``: the JAX package reads
      it with orbax, which the port does without;
    * any other existing path: a reference ``.pt`` state_dict.

    Any other failure (a missing or unreadable file) falls back to seeded
    random init with the reference's warning (unet.py:94-98). ``dtype``
    (default ``cfg.dtype``) is the torso dtype; a bfloat16 torso gets
    :func:`cast_params_half`."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if is_orbax_checkpoint(model_path):
        raise NotImplementedError(
            f"{model_path} is an orbax checkpoint: the port reads .msgpack and .pt only "
            "(ROADMAP queue 1, orbax reading); save it as .msgpack with the JAX package's "
            "save_params_msgpack")
    try:
        if model_path and model_path.endswith(".msgpack"):
            model = unet_from_msgpack(model_path, cfg, seed)
        elif model_path and os.path.exists(model_path):
            model = init_unet(cfg, seed)
            model.load_state_dict(torch.load(model_path, map_location="cpu", weights_only=True))
        else:
            raise FileNotFoundError(model_path)
    except CheckpointMismatch:
        raise
    except Exception as e:  # the reference's broad fallback, reported as it does
        print(f"Got exception: {e} / Randomly initialize")
        model = init_unet(cfg, seed)
    if cfg.dtype != torch.float32:
        cast_params_half(model, cfg.dtype)
    model.requires_grad_(False).eval()
    return model.to(device=device, memory_format=torch.channels_last)
