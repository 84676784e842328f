"""Seeded random weights for the UNet, drawn on the device.

The rule (frozen here; it follows the seeded random-init checkpoint of the
repository's rehearsal tools): every weight and bias of a convolution or a
linear layer is uniform in +-1/sqrt(fan_in), PyTorch's default init; every
GroupNorm weight is 1; and the leaves that PyTorch's init would leave at
zero (GroupNorm biases, and the zero-initialized output convolutions of each
ResBlock, attention block and of the model) are 0.02 N(0, 1), so that every
path of the UNet carries signal and the comparison sees all of it.

The draw is a few large calls on one ``torch.Generator`` on the device, in
chunks of the flattened parameter list, and gives the same bits for the same
seed and the same list of shapes, so the program and the plain reference are
filled with the same tensors.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

CHUNK = 1 << 26  # elements drawn per call (256 MiB of fp32)
ZERO_INIT = ("out_layers.3.", "proj_out.", "out.2.")
NORMS = ("in_layers.0.", "out_layers.0.", "norm.", "out.0.")


def _kind(name: str) -> str:
    if any(z in name for z in ZERO_INIT):
        return "normal"
    if any(n in name for n in NORMS):
        return "ones" if name.endswith("weight") else "normal"
    return "uniform"


def specs(named_shapes: List[Tuple[str, torch.Size]]) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) for each leaf, in the given order."""
    out, fan = [], {}
    for name, shape in named_shapes:
        if name.endswith("weight") and len(shape) > 1:
            fan[name[:-len("weight")]] = int(math.prod(shape[1:]))
    for name, shape in named_shapes:
        kind = _kind(name)
        scale = 0.02 if kind == "normal" else 1.0
        if kind == "uniform":
            scale = 1.0 / math.sqrt(fan[name.rsplit(".", 1)[0] + "."])
        out.append((name, tuple(shape), kind, scale))
    return out


def draw(named_shapes, seed: int, device, sink: Callable[[str, torch.Tensor], None]):
    """Draw the seeded weights, fp32 on ``device``, and hand each leaf to
    ``sink(name, tensor)`` as soon as its chunk is drawn."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pending, size = [], 0

    def flush():
        nonlocal pending, size
        u = torch.empty(size, device=device).uniform_(-1.0, 1.0, generator=gen)
        z = torch.randn(size, device=device, generator=gen)
        off = 0
        for name, shape, kind, scale in pending:
            n = math.prod(shape)
            if kind == "ones":
                sink(name, torch.ones(shape, device=device))
            else:
                sink(name, ((z if kind == "normal" else u)[off:off + n] * scale).view(shape))
            off += n
        pending, size = [], 0

    for s in specs(sorted(named_shapes, key=lambda ns: ns[0])):  # one order for any module
        n = math.prod(s[1])
        if size and size + n > CHUNK:
            flush()
        pending.append(s)
        size += n
    if pending:
        flush()


def fill(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill ``module``'s parameters with the seeded weights of their names
    and shapes (each parameter keeps its own dtype and memory format)."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    with torch.no_grad():
        draw([(n, p.shape) for n, p in params.items()], seed, device,
             lambda name, w: params[name].copy_(w))
    return module
