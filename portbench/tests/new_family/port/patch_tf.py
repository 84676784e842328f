"""The program's side of the harness tests' family ``patch_tf``: a patch
transformer with adaLN-Zero blocks, written as a port's model module would
be (fused LayerNorm, GELU and attention calls, patches cut by one
``unfold``), where a port keeps it (``<package>/models/<name>.py``). Its
parameter names are the reference's, so one seeded draw fills both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int):
        super().__init__()
        self.heads = heads
        self.ada = nn.Linear(hidden, 6 * hidden)
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)
        self.fc1 = nn.Linear(hidden, mlp)
        self.fc2 = nn.Linear(mlp, hidden)

    def forward(self, x, c):
        mods = self.ada(F.silu(c))[:, None].chunk(6, dim=-1)
        b, t, h = x.shape
        y = F.layer_norm(x, (h,), eps=1e-6) * (1 + mods[1]) + mods[0]
        q, k, v = self.qkv(y).view(b, t, 3, self.heads, h // self.heads).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(h // self.heads), dim=-1) @ v
        x = x + mods[2] * self.proj(a.transpose(1, 2).reshape(b, t, h))
        y = F.layer_norm(x, (h,), eps=1e-6) * (1 + mods[4]) + mods[3]
        return x + mods[5] * self.fc2(F.gelu(self.fc1(y), approximate="tanh"))


class PatchTransformer(nn.Module):
    """``model(x, t)``: x [B, S, S, in_channels] and timesteps [B] to
    [B, S, S, out_channels]."""

    def __init__(self, image_size: int, patch: int, hidden: int, depth: int, heads: int,
                 mlp: int, freq: int, in_channels: int, out_channels: int):
        super().__init__()
        self.patch, self.freq, self.out_channels = patch, freq, out_channels
        tokens = (image_size // patch) ** 2
        self.x_embed = nn.Linear(in_channels * patch * patch, hidden)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden))
        self.t_embed = nn.Sequential(nn.Linear(freq, hidden), nn.SiLU(), nn.Linear(hidden, hidden))
        self.blocks = nn.ModuleList(Block(hidden, heads, mlp) for _ in range(depth))
        self.final_ada = nn.Linear(hidden, 2 * hidden)
        self.final = nn.Linear(hidden, out_channels * patch * patch)

    def forward(self, x, timesteps):
        b, size, _, cin = x.shape
        p = self.patch
        # [B, C, S, S] -> [B, C p p, tokens]: the channel-major patch order of the
        # reference's [p, p, C] rows, permuted back below
        cols = F.unfold(x.permute(0, 3, 1, 2), kernel_size=p, stride=p)
        cols = cols.view(b, cin, p * p, -1).permute(0, 3, 2, 1).reshape(b, -1, p * p * cin)
        h = self.x_embed(cols) + self.pos_embed
        half = self.freq // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(half, device=x.device) / half)
        args = timesteps.float()[:, None] * freqs[None]
        c = self.t_embed(torch.cat([torch.cos(args), torch.sin(args)], dim=-1))
        for block in self.blocks:
            h = block(h, c)
        shift, scale = self.final_ada(F.silu(c))[:, None].chunk(2, dim=-1)
        out = self.final(F.layer_norm(h, (h.shape[-1],), eps=1e-6) * (1 + scale) + shift)
        out = out.view(b, -1, p * p, self.out_channels).permute(0, 3, 2, 1)
        out = F.fold(out.reshape(b, self.out_channels * p * p, -1), (size, size), p, stride=p)
        return out.permute(0, 2, 3, 1)
