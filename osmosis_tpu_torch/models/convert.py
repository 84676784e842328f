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
:func:`load_params_orbax` reads the JAX package's orbax checkpoint
directories (OCDBT and zarr v2, ``utils/ocdbt.py``) without orbax or
tensorstore, and :func:`save_params_orbax` writes one that both packages'
``load_params_orbax`` read.
:func:`cast_params_half` is the counterpart of the JAX package's
``cast_params_half``: the bf16 torso's weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import msgpack, ocdbt, zstd
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


# How a state_dict entry and its JAX leaf correspond: "vec" a 1-D leaf as it
# is (biases, GroupNorm affines); "conv" OIHW <-> HWIO; "dense" a Linear's
# [out, in] <-> [in, out]; "token" a 1x1 Conv1d's [out, in, 1] <-> [in, out];
# "qkv" and "qkv_bias" the same with the legacy head-major qkv channels
# permuted to JAX's part-major order.
def _to_jax(a: np.ndarray, kind: str, perm) -> np.ndarray:
    if kind == "vec":
        return a
    if kind == "qkv_bias":
        return a[perm]
    if kind == "conv":
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
    if kind == "dense":
        return np.ascontiguousarray(a.T)
    if kind == "token":
        return np.ascontiguousarray(a[:, :, 0].T)
    return np.ascontiguousarray(a[:, :, 0][perm].T)  # qkv


def _to_torch(a: np.ndarray, kind: str, perm) -> np.ndarray:
    if kind == "vec":
        return a
    if kind == "qkv_bias":
        out = np.empty_like(a)
        out[perm] = a
        return out
    if kind == "conv":
        return np.transpose(a, (3, 2, 0, 1))
    if kind == "dense":
        return a.T
    if kind == "token":
        return a.T[:, :, None]
    out = np.empty((a.shape[1], a.shape[0]), a.dtype)  # qkv
    out[perm] = a.T
    return out[:, :, None]


def jax_leaf_shape(kind: str, torch_shape) -> tuple:
    """The JAX shape of a leaf whose state_dict entry has ``torch_shape``."""
    s = tuple(torch_shape)
    if kind in ("vec", "qkv_bias"):
        return s
    if kind == "conv":
        return (s[2], s[3], s[1], s[0])
    return (s[1], s[0])  # dense, token, qkv


def leaf_map(cfg: UNetConfig) -> Dict[str, tuple]:
    """``{state_dict name: (JAX path under "params", kind, qkv permutation
    or None)}`` for every parameter of the UNet, in the JAX tree's order:
    the one correspondence that :func:`state_dict_from_jax`,
    :func:`params_from_state_dict` and the tensor-parallel layout
    (``parallel/mesh``) read."""
    legacy = not cfg.use_new_attention_order
    out: Dict[str, tuple] = {}

    def norm(prefix, path):
        out[f"{prefix}.weight"] = (path + ("scale",), "vec", None)
        out[f"{prefix}.bias"] = (path + ("bias",), "vec", None)

    def kernel(prefix, path, kind, perm=None):
        out[f"{prefix}.weight"] = (path + ("kernel",), kind, perm)
        out[f"{prefix}.bias"] = (path + ("bias",), "qkv_bias" if kind == "qkv" else "vec", perm)

    kernel("time_embed.0", ("time_dense0",), "dense")
    kernel("time_embed.2", ("time_dense1",), "dense")
    norm("out.0", ("out_norm",))
    kernel("out.2", ("out_conv",), "conv")

    def layer(lay: dict, prefix: str, name: str):
        kind = lay["kind"]
        if kind == "conv_in":
            kernel(prefix, (name,), "conv")
        elif kind in ("res", "res_down", "res_up"):
            norm(f"{prefix}.in_layers.0", (name, "in_norm"))
            kernel(f"{prefix}.in_layers.2", (name, "in_conv"), "conv")
            kernel(f"{prefix}.emb_layers.1", (name, "emb_proj"), "dense")
            norm(f"{prefix}.out_layers.0", (name, "out_norm"))
            kernel(f"{prefix}.out_layers.3", (name, "out_conv"), "conv")
            if lay["in_ch"] != lay["out_ch"]:
                kernel(f"{prefix}.skip_connection", (name, "skip"), "conv")
        elif kind == "attn":
            norm(f"{prefix}.norm", (name, "norm"))
            kernel(f"{prefix}.qkv", (name, "qkv"), "qkv",
                   _qkv_permutation(lay["ch"], lay["heads"], legacy))
            kernel(f"{prefix}.proj_out", (name, "proj"), "token")
        elif kind == "down":
            kernel(f"{prefix}.op", (name, "op"), "conv")
        elif kind == "up":
            kernel(f"{prefix}.conv", (name, "conv"), "conv")
        else:
            raise ValueError(kind)

    _walk_plan(cfg, layer)
    return out


def state_dict_from_jax(params: Dict[str, Any], cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX UNetModel params (nested dict of numpy arrays or tensors, with or
    without the top-level ``"params"`` key) -> this package's UNet state_dict,
    fp32 on the CPU."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for name, (path, kind, perm) in leaf_map(cfg).items():
        leaf = p
        for k in path:
            leaf = leaf[k]
        sd[name] = _t(_to_torch(_np(leaf), kind, perm))
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
    params: Dict[str, Any] = {}
    for name, (path, kind, perm) in leaf_map(cfg).items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _to_jax(_np(sd[name]), kind, perm)
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


def load_params_orbax(path: str) -> Dict[str, Any]:
    """Read an orbax checkpoint directory (the JAX package's
    ``save_params_orbax``): the parameter tree as ``_METADATA``'s
    ``tree_metadata`` keys it, numpy arrays, bfloat16 leaves as bf16 tensors
    (as :func:`load_params_msgpack` gives them). A damaged or truncated
    directory raises ``utils.ocdbt.OcdbtError``; a missing one raises
    ``FileNotFoundError``."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ocdbt.OcdbtError(f"{path}: not an OCDBT checkpoint of zarr v2 arrays "
                               f"(use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                               f"{meta.get('use_zarr3')})")
    db = ocdbt.Database(path)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        if any(k["key_type"] != 2 for k in entry["key_metadata"]):
            raise ocdbt.OcdbtError(f"{path}: {keys} is not a path of dict keys")
        arr, bf16 = ocdbt.read_array(db, ".".join(keys))
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr
    return tree


def _orbax_leaves(tree: Dict[str, Any], keys=()):
    """(path of dict keys, leaf) for every leaf of a parameter tree, in the
    order ``jax.tree_util`` flattens it (dict keys sorted)."""
    for k in sorted(tree):
        if not isinstance(k, str):
            raise ValueError(f"{keys + (k,)}: orbax paths here are string dict keys")
        v = tree[k]
        if isinstance(v, dict):
            yield from _orbax_leaves(v, keys + (k,))
        else:
            yield keys + (k,), v


def _zarr_leaf(leaf):
    """(C-order numpy array of the leaf's bytes, zarr dtype): a bfloat16
    tensor or array as its uint16 bits under ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, from the JAX package
        return arr.view(np.uint16), "bfloat16"
    if arr.dtype.hasobject or arr.dtype.names:
        raise ValueError(f"orbax: dtype {arr.dtype} is not written")
    return arr, arr.dtype.str


def save_params_orbax(params: Dict[str, Any], path: str) -> None:
    """Write a parameter tree as the JAX package's ``save_params_orbax``
    does (orbax's ``StandardCheckpointer``, ``force=True``): a directory of
    ``_METADATA``, ``_CHECKPOINT_METADATA`` and one OCDBT database holding a
    zarr v2 array per leaf (``utils/ocdbt``), without orbax or tensorstore.
    Leaves are numpy arrays or tensors (bfloat16 kept); each is one zarr
    chunk up to ``ocdbt.CHUNK_BYTES``. The directory is written beside
    ``path``; at the end what was at ``path`` is renamed aside, the new one
    renamed onto ``path`` and the old one removed, so a crash at any point
    leaves each of the two whole under one of the three names."""
    path = os.path.abspath(path)
    leaves = list(_orbax_leaves(params))
    tmp = f"{path}.orbax-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    init = time.time_ns()
    try:
        with ocdbt.Writer(tmp) as writer:
            for keys, leaf in leaves:
                arr, dtype = _zarr_leaf(leaf)
                ocdbt.write_array(writer, ".".join(keys), arr, dtype)
        meta = {"tree_metadata": {str(keys): {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
            for keys, _ in leaves},
            "use_ocdbt": True, "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                                        "standard_checkpoint_handler.StandardCheckpointHandler",
                       "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": init,
                       "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    old = f"{path}.orbax-old-{os.getpid()}"
    shutil.rmtree(old, ignore_errors=True)
    had_old = os.path.lexists(path)
    if had_old:
        os.replace(path, old)
    try:
        os.replace(tmp, path)
    except BaseException:
        if had_old:
            os.replace(old, path)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if had_old:
        shutil.rmtree(old) if os.path.isdir(old) and not os.path.islink(old) else os.remove(old)


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
    """A checkpoint that reads but does not fit the model's config (the
    UNet's here, the DiT's in ``models/dit``)."""


def unet_from_msgpack(path: str, cfg: UNetConfig, seed: int = 0) -> UNetModel:
    """A UNet on the CPU, fp32 and trainable, holding the weights of a
    ``.msgpack`` parameter tree (carried over by :func:`state_dict_from_jax`).
    A missing or unreadable file raises; a tree that does not fit ``cfg``
    raises :class:`CheckpointMismatch`, as the JAX model would when it
    applies it."""
    return unet_from_params(load_params_msgpack(path), cfg, path, seed)


def unet_from_params(params: Dict[str, Any], cfg: UNetConfig, path: str,
                     seed: int = 0) -> UNetModel:
    """:func:`unet_from_msgpack` for a tree already read (from ``path``)."""
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
    * an orbax directory: :func:`load_params_orbax`, then as ``.msgpack``;
      a missing, damaged or unreadable one raises (the JAX loader falls back
      to random init), and the line printed names the zstd decoder;
    * any other existing path: a reference ``.pt`` state_dict.

    Any other failure (a missing or unreadable file) falls back to seeded
    random init with the reference's warning (unet.py:94-98). ``dtype``
    (default ``cfg.dtype``) is the torso dtype; a bfloat16 torso gets
    :func:`cast_params_half`."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if is_orbax_checkpoint(model_path):
        print(f"Reading the orbax checkpoint {model_path} (zstd decoder: {zstd.decoder()})")
        model = unet_from_params(load_params_orbax(model_path), cfg, model_path, seed)
    else:
        model = _load_file(model_path, cfg, seed)
    if cfg.dtype != torch.float32:
        cast_params_half(model, cfg.dtype)
    model.requires_grad_(False).eval()
    return model.to(device=device, memory_format=torch.channels_last)


def _load_file(model_path: Optional[str], cfg: UNetConfig, seed: int) -> UNetModel:
    """A ``.msgpack`` or ``.pt`` checkpoint, with the reference's fallback."""
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
    return model
