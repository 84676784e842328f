"""A model family that is not the ADM UNet, as a later configuration would
bring one: a two-block patch transformer with adaLN-Zero blocks (DiT's),
4 channels in and 8 out, the Osmosis UNet's own I/O and learned range.

Its sizes are the configuration's ``model`` section; the program's model is
``port/patch_tf.py`` beside the benchmark's folder, where a port keeps its
models; the reference is ``reference/patch_tf.py``. Both are loaded by
path, so that the family works from a copy of the benchmark's folder.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from harness import load, weights

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ref = load(HOME, "reference", "patch_tf")
port = load(os.path.dirname(HOME), "port", "patch_tf")
ZERO_INIT = ("pos_embed", ".ada.", "final_ada.", "final.")  # zero in DiT's own init


def leaf_kind(name: str) -> str:
    return "normal" if any(z in name for z in ZERO_INIT) else "uniform"


def sizes(config: dict, overrides: dict):
    return ref.Sizes(**{**config["model"], **overrides})


def torso_dtype(config: dict) -> torch.dtype:
    return torch.float32


def program(config: dict, s, overrides: dict, seed: int, device) -> torch.nn.Module:
    with torch.device(device):
        model = port.PatchTransformer(**dataclasses.asdict(s))
    return weights.fill(model, seed, leaf_kind).requires_grad_(False).eval()


def reference(s, seed: int, device) -> torch.nn.Module:
    with torch.device(device):
        model = ref.PatchTransformer(s)
    return weights.fill(model, seed, leaf_kind).requires_grad_(False).eval()


def flop(s, batch: int = 1):
    """(forward, x-only pullback) FLOP of one call at ``batch``: the matrix
    products, 2 FLOP a multiply-add; the conditioning's (the timestep's
    embedding and the adaLN projections) has no pullback, and the
    attention's two products take two each in it."""
    t, h, pp = s.tokens, s.hidden, s.patch * s.patch
    cond = 2 * s.freq * h + 2 * h * h + s.depth * 2 * h * 6 * h + 2 * h * 2 * h
    io = 2 * t * s.in_channels * pp * h + 2 * t * h * s.out_channels * pp
    dense = s.depth * (2 * t * h * 3 * h + 2 * t * h * h + 2 * 2 * t * h * s.mlp)
    attn = s.depth * 2 * (2 * t * t * h)
    return batch * (cond + io + dense + attn), batch * (io + dense + 2 * attn)
