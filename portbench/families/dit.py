"""DiT (Peebles and Xie, ICCV 2023; ``facebookresearch/DiT`` ``models.py``)
as the RGBD prior: everything the harness needs to know of a configuration
whose model is the port's ``DiTModel`` (``osmosis_tpu_torch/models/dit.py``).

Its sizes are the preset's ``dit_model`` section (``reference.dit.Sizes``);
the program's model is built by the port's own dispatch
(``models/preset.load_model``, which ``run_restoration`` calls), then filled
with the seeded weights; the reference is ``reference/dit.py``; the FLOP a
step takes are ``yardstick/dit_cost.flop``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from harness import weights
from osmosis_tpu_torch.models.preset import load_model
from reference.dit import DiT, Sizes
from yardstick import dit_cost

ZERO_INIT = ("adaLN_modulation", "final_layer")  # zero in DiT's own init
flop = dit_cost.flop  # (forward, x-only pullback) FLOP of a call at a batch


def leaf_kind(name: str) -> str:
    """The weight rule (``harness/weights.py``): the leaves DiT's init sets
    to zero (every adaLN modulation and the final layer) 0.02 N(0, 1), so
    that each block's gates and the output carry signal; the rest PyTorch's
    default. The position table is a buffer, the same in both models."""
    return "normal" if any(z in name for z in ZERO_INIT) else "uniform"


def sizes(config: dict, overrides: dict) -> Sizes:
    """The DiT's sizes from the preset's ``dit_model``, with the tests'
    smaller ones."""
    return Sizes.from_section(config["preset"]["dit_model"], **overrides)


def torso_dtype(config: dict) -> torch.dtype:
    return torch.bfloat16 if config["preset"]["dit_model"].get("use_fp16") else torch.float32


def program(config: dict, s: Sizes, overrides: dict, seed: int, device) -> torch.nn.Module:
    """The port's DiT as ``run_restoration`` builds it from the preset
    (``load_model``: no checkpoint, so DiT's init, cast to the torso dtype,
    frozen, on ``device``), then filled with the seeded weights, each
    rounded to its parameter's dtype as the cast rounds it."""
    section = dict(config["preset"]["dit_model"], **overrides, model_path="")
    model = load_model(SimpleNamespace(dit_model=section), device, torso_dtype(config))
    return weights.fill(model, seed, leaf_kind)


def reference(s: Sizes, seed: int, device) -> DiT:
    """The plain fp32 DiT filled with the program's bits; ``set_quant``
    rounds its products' operands for the control."""
    with torch.device(device):
        ref = DiT(s)
    return weights.fill(ref, seed, leaf_kind).requires_grad_(False).eval()
