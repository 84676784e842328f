"""DiT (Peebles and Xie, "Scalable Diffusion Models with Transformers", ICCV
2023, arXiv:2212.09748) in plain PyTorch and float32, NHWC at the boundary:
the plain reference of the benchmark's family ``dit``.

Written from ``facebookresearch/DiT`` ``models.py``: ``PatchEmbed`` (a
``Conv2d`` of kernel and stride p), the fixed 2-D sin-cos position table of
``get_2d_sincos_pos_embed`` (numpy, float64), the ``TimestepEmbedder`` (256
frequencies, [cos, sin]), ``depth`` adaLN-Zero blocks (LayerNorm without
affine, eps 1e-6, then ``x (1 + scale) + shift``; timm's ``Attention`` with
a qkv bias, its channels (part, head, dim); timm's ``Mlp`` with GELU-tanh;
each branch added back through its gate) and the ``FinalLayer``, then
``unpatchify``. The departures are the port's (``models/dit.py``):
unconditional (no ``y_embedder``), on the 4-channel RGBD image, not latents.
Parameter names are DiT's, so one seeded draw fills this model and the
program's.

No kernel and no fused op: the attention is ``softmax(q k^T / sqrt(d)) v``
written out in fp32 (``F.scaled_dot_product_attention`` is not used), with
``F.layer_norm`` and ``F.gelu(approximate="tanh")``. TF32 is turned off for
matrix products and cuDNN when the module is loaded. Under autograd each
block runs under ``torch.utils.checkpoint`` (``remat``), so that the x-only
pullback at 4096 tokens holds one block's probabilities and logits at a
time (about 2.1 GB at 16 heads) rather than every block's. ``quant`` rounds
the operands of every product (the patch embedding, each linear layer and
both attention products) before it runs: the control
(:mod:`reference.lowp`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A preset's ``dit_model`` sizes (DiT-XL/4 by default)."""

    image_size: int = 256
    patch_size: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    frequency_embedding_size: int = 256
    in_channels: int = 4
    learn_sigma: bool = True

    @classmethod
    def from_section(cls, section: dict, **overrides) -> "Sizes":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{**{k: v for k, v in section.items() if k in names}, **overrides})

    @property
    def out_channels(self) -> int:
        return 2 * self.in_channels if self.learn_sigma else self.in_channels

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens(self) -> int:
        return self.grid ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


def get_1d_sincos_pos_embed_from_grid(embed_dim, pos):
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim, grid_size):
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape([2, 1, grid_size, grid_size])
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def timestep_embedding(t, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(start=0, end=half, dtype=torch.float32)
                      / half).to(device=t.device)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def modulate(x, shift, scale):
    return x * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


def layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _plain(t):
    return t


class Dense(nn.Linear):
    def forward(self, x):
        q = getattr(self, "quant", None) or _plain
        return F.linear(q(x), q(self.weight), self.bias)


class PatchConv(nn.Conv2d):
    def forward(self, x):
        q = getattr(self, "quant", None) or _plain
        return F.conv2d(q(x), q(self.weight), self.bias, self.stride)


class PatchEmbed(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.proj = PatchConv(s.in_channels, s.hidden_size, s.patch_size, stride=s.patch_size)

    def forward(self, x_nchw):
        return self.proj(x_nchw).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.freq = s.frequency_embedding_size
        self.mlp = nn.Sequential(Dense(self.freq, s.hidden_size), nn.SiLU(),
                                 Dense(s.hidden_size, s.hidden_size))

    def forward(self, t):
        return self.mlp(timestep_embedding(t, self.freq))


class Attention(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.heads = s.num_heads
        self.qkv = Dense(s.hidden_size, 3 * s.hidden_size)
        self.proj = Dense(s.hidden_size, s.hidden_size)

    def forward(self, x):
        q8 = getattr(self, "quant", None) or _plain
        b, n, c = x.shape
        d = c // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        logits = torch.einsum("bhtd,bhsd->bhts", q8(q), q8(k)) / math.sqrt(d)
        a = torch.einsum("bhts,bhsd->bhtd", q8(logits.softmax(dim=-1)), q8(v))
        return self.proj(a.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.fc1 = Dense(s.hidden_size, s.mlp_hidden)
        self.fc2 = Dense(s.mlp_hidden, s.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.attn = Attention(s)
        self.mlp = Mlp(s)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Dense(s.hidden_size, 6 * s.hidden_size))

    def forward(self, x, c):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            self.adaLN_modulation(c).chunk(6, dim=1))
        x = x + gate_msa.unsqueeze(1) * self.attn(modulate(layer_norm(x), shift_msa, scale_msa))
        return x + gate_mlp.unsqueeze(1) * self.mlp(modulate(layer_norm(x), shift_mlp, scale_mlp))


class FinalLayer(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.linear = Dense(s.hidden_size, s.patch_size ** 2 * s.out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Dense(s.hidden_size, 2 * s.hidden_size))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class DiT(nn.Module):
    """``model(x, t)``: x [B, H, W, in_channels] and timesteps [B] to
    [B, H, W, out_channels], fp32."""

    def __init__(self, s: Sizes, remat: bool = True):
        super().__init__()
        self.s, self.remat = s, remat
        self.x_embedder = PatchEmbed(s)
        self.t_embedder = TimestepEmbedder(s)
        pos = get_2d_sincos_pos_embed(s.hidden_size, s.grid)  # on the device the model is built on
        self.register_buffer("pos_embed", torch.tensor(pos, dtype=torch.float32).unsqueeze(0))
        self.blocks = nn.ModuleList(DiTBlock(s) for _ in range(s.depth))
        self.final_layer = FinalLayer(s)

    def set_quant(self, quant: Quant):
        for m in self.modules():
            if isinstance(m, (Dense, PatchConv, Attention)):
                m.quant = quant
        return self

    def unpatchify(self, x):
        c, p, h = self.s.out_channels, self.s.patch_size, self.s.grid
        x = torch.einsum("nhwpqc->nchpwq", x.reshape(x.shape[0], h, h, p, p, c))
        return x.reshape(x.shape[0], c, h * p, h * p)

    def forward(self, x_nhwc, timesteps):
        x = self.x_embedder(x_nhwc.permute(0, 3, 1, 2).float()) + self.pos_embed
        c = self.t_embedder(timesteps)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, c, use_reentrant=False)
            else:
                x = block(x, c)
        return self.unpatchify(self.final_layer(x, c)).permute(0, 2, 3, 1)
