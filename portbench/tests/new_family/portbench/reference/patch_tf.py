"""A patch transformer with adaLN-Zero blocks, after DiT (Peebles and Xie,
"Scalable Diffusion Models with Transformers", ICCV 2023), in plain
PyTorch and float32, NHWC at the boundary: the plain reference of the
harness tests' family ``patch_tf``.

Each block: LayerNorm without affine, then ``x * (1 + scale) + shift`` from
the conditioning c (the timestep's embedding), multi-head self-attention
and a GELU-tanh MLP, each added back through a gate from c. The head: a
modulated LayerNorm and a linear layer to the patches' output channels.
No kernel and no fused op; ``quant`` rounds the operands of every matrix
product before it runs (the control).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Sizes:
    image_size: int = 32
    patch: int = 4
    hidden: int = 64
    depth: int = 2
    heads: int = 4
    mlp: int = 256
    freq: int = 64            # sinusoidal features of the timestep
    in_channels: int = 4
    out_channels: int = 8

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2


def _plain(t):
    return t


class Dense(nn.Linear):
    def forward(self, x):
        q = getattr(self, "quant", None) or _plain
        return F.linear(q(x), q(self.weight), self.bias)


def layer_norm(x):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def timestep_embedding(t, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Block(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.heads = s.heads
        self.ada = Dense(s.hidden, 6 * s.hidden)
        self.qkv = Dense(s.hidden, 3 * s.hidden)
        self.proj = Dense(s.hidden, s.hidden)
        self.fc1 = Dense(s.hidden, s.mlp)
        self.fc2 = Dense(s.mlp, s.hidden)

    def forward(self, x, c):
        q8 = getattr(self, "quant", None) or _plain
        shift1, scale1, gate1, shift2, scale2, gate2 = self.ada(F.silu(c)).chunk(6, dim=-1)
        b, t, h = x.shape
        qkv = self.qkv(modulate(layer_norm(x), shift1, scale1))
        q, k, v = qkv.reshape(b, t, 3, self.heads, h // self.heads).unbind(2)
        w = torch.einsum("bthd,bshd->bhts", q8(q), q8(k)) / math.sqrt(h // self.heads)
        a = torch.einsum("bhts,bshd->bthd", q8(w.softmax(dim=-1)), q8(v)).reshape(b, t, h)
        x = x + gate1[:, None] * self.proj(a)
        y = self.fc2(gelu_tanh(self.fc1(modulate(layer_norm(x), shift2, scale2))))
        return x + gate2[:, None] * y


class PatchTransformer(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.s = s
        pp = s.patch * s.patch
        self.x_embed = Dense(s.in_channels * pp, s.hidden)
        self.pos_embed = nn.Parameter(torch.zeros(1, s.tokens, s.hidden))
        self.t_embed = nn.Sequential(Dense(s.freq, s.hidden), nn.SiLU(), Dense(s.hidden, s.hidden))
        self.blocks = nn.ModuleList(Block(s) for _ in range(s.depth))
        self.final_ada = Dense(s.hidden, 2 * s.hidden)
        self.final = Dense(s.hidden, s.out_channels * pp)

    def set_quant(self, quant: Quant):
        for m in self.modules():
            if isinstance(m, (Dense, Block)):
                m.quant = quant
        return self

    def forward(self, x_nhwc, timesteps):
        s, b = self.s, x_nhwc.shape[0]
        n, p = s.image_size // s.patch, s.patch
        x = x_nhwc.float().reshape(b, n, p, n, p, s.in_channels).permute(0, 1, 3, 2, 4, 5)
        x = self.x_embed(x.reshape(b, n * n, p * p * s.in_channels)) + self.pos_embed
        c = self.t_embed(timestep_embedding(timesteps, s.freq))
        for block in self.blocks:
            x = block(x, c)
        shift, scale = self.final_ada(F.silu(c)).chunk(2, dim=-1)
        out = self.final(modulate(layer_norm(x), shift, scale))
        out = out.reshape(b, n, n, p, p, s.out_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, s.image_size, s.image_size, s.out_channels)
