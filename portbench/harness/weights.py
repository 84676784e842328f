"""Seeded random weights for a model, drawn on the device.

Each leaf is of one of three kinds, which its family's rule picks by the
leaf's name (``leaf_kind(name)`` of ``families/<family>.py``):
``"uniform"``, uniform in +-1/sqrt(fan_in), PyTorch's default init for a
convolution's or a linear layer's weight and bias; ``"ones"``, a norm's
weight; ``"normal"``, 0.02 N(0, 1), for the leaves that PyTorch's init would
leave at zero (a norm's bias, a zero-initialized projection), so that every
path of the model carries signal and the comparison sees all of it.

The draw is a few large calls on one ``torch.Generator`` on the device, in
chunks of the flattened parameter list, and gives the same bits for the same
seed, the same rule and the same list of names and shapes, so the program
and the plain reference are filled with the same tensors.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

CHUNK = 1 << 26  # elements drawn per call (256 MiB of fp32)
Rule = Callable[[str], str]  # a leaf's name -> "uniform", "ones" or "normal"


def specs(named_shapes: List[Tuple[str, torch.Size]],
          kind: Rule) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) for each leaf, in the given order."""
    out, fan = [], {}
    for name, shape in named_shapes:
        if name.endswith("weight") and len(shape) > 1:
            fan[name[:-len("weight")]] = int(math.prod(shape[1:]))
    for name, shape in named_shapes:
        k = kind(name)
        scale = 0.02 if k == "normal" else 1.0
        if k == "uniform":
            scale = 1.0 / math.sqrt(fan[name.rsplit(".", 1)[0] + "."])
        out.append((name, tuple(shape), k, scale))
    return out


def draw(named_shapes, seed: int, device, sink: Callable[[str, torch.Tensor], None],
         kind: Rule):
    """Draw the seeded weights, fp32 on ``device``, and hand each leaf to
    ``sink(name, tensor)`` as soon as its chunk is drawn."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pending, size = [], 0

    def flush():
        nonlocal pending, size
        u = torch.empty(size, device=device).uniform_(-1.0, 1.0, generator=gen)
        z = torch.randn(size, device=device, generator=gen)
        off = 0
        for name, shape, k, scale in pending:
            n = math.prod(shape)
            if k == "ones":
                sink(name, torch.ones(shape, device=device))
            else:
                sink(name, ((z if k == "normal" else u)[off:off + n] * scale).view(shape))
            off += n
        pending, size = [], 0

    for s in specs(sorted(named_shapes, key=lambda ns: ns[0]), kind):  # one order for any module
        n = math.prod(s[1])
        if size and size + n > CHUNK:
            flush()
        pending.append(s)
        size += n
    if pending:
        flush()


def fill(module: torch.nn.Module, seed: int, kind: Rule) -> torch.nn.Module:
    """Fill ``module``'s parameters with the seeded weights of their names
    and shapes under the rule ``kind`` (each parameter keeps its own dtype
    and memory format)."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    with torch.no_grad():
        draw([(n, p.shape) for n, p in params.items()], seed, device,
             lambda name, w: params[name].copy_(w), kind)
    return module
