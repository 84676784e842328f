"""The ADM UNet of guided-diffusion (Dhariwal and Nichol, 2021), as the
Osmosis checkpoint configures it, in plain PyTorch and float32.

Written from the published architecture (``guided_diffusion/unet.py``),
NCHW inside, NHWC at the boundary like the program under test. Parameter
names are guided-diffusion's own (``input_blocks.{i}.{j}.in_layers.0``, ...),
so one state dict fills this model and the program's. No kernel, cache or
fused op: ``F.group_norm`` with fp32 statistics, ``F.silu``, ``F.conv2d``,
nearest upsampling, 2x2 average pooling, and legacy (head-major) QKV
attention with its softmax in fp32.

``quant`` (default: none) rounds the operands of every convolution and
matrix product before it runs; :mod:`reference.lowp` gives the fp8 rounding
of the bf16 configuration's control.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Arch:
    """The UNet's sizes (guided-diffusion's ``create_model`` arguments)."""

    image_size: int = 256
    in_channels: int = 4
    model_channels: int = 256
    out_channels: int = 8
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (8, 16, 32)   # downsample rates with attention
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_head_channels: int = 64

    @classmethod
    def from_preset(cls, unet_model: dict, **overrides) -> "Arch":
        """From a preset's ``unet_model`` section: the osmosis 4-in / 8-out
        head, ``attention_resolutions`` as image sizes, the default channel
        multipliers of guided-diffusion for an empty ``channel_mult``."""
        size = int(unet_model["image_size"])
        att = unet_model.get("attention_resolutions", "16")
        att = [int(a) for a in str(att).split(",")] if not isinstance(att, (list, tuple)) else att
        mult = unet_model.get("channel_mult", "")
        if mult in ("", None):
            mult = {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}[size]
        elif isinstance(mult, str):
            mult = tuple(int(m) for m in mult.split(","))
        if not (unet_model.get("use_scale_shift_norm") and unet_model.get("resblock_updown")):
            raise NotImplementedError("the reference builds scale-shift norm with resblock_updown")
        if int(unet_model.get("num_head_channels", -1)) <= 0:
            raise NotImplementedError("the reference builds heads of num_head_channels")
        if unet_model.get("use_new_attention_order"):
            raise NotImplementedError("the reference builds the legacy attention order")
        kw = dict(image_size=size, model_channels=int(unet_model["num_channels"]),
                  num_res_blocks=int(unet_model["num_res_blocks"]),
                  attention_ds=tuple(size // int(a) for a in att), channel_mult=tuple(mult),
                  num_head_channels=int(unet_model["num_head_channels"]))
        kw.update(overrides)
        return cls(**kw)


def plan(arch: Arch):
    """The layer list of guided-diffusion's ``UNetModel.__init__``: (input
    blocks, middle block, output blocks), each block a list of layers
    ``(kind, channels in, channels out, resolution)``."""
    mc = arch.model_channels
    ch, res = arch.channel_mult[0] * mc, arch.image_size
    inputs: List[list] = [[("conv_in", arch.in_channels, ch, res)]]
    chans = [ch]
    ds = 1
    for level, mult in enumerate(arch.channel_mult):
        for _ in range(arch.num_res_blocks):
            block = [("res", ch, mult * mc, res)]
            ch = mult * mc
            if ds in arch.attention_ds:
                block.append(("attn", ch, ch, res))
            inputs.append(block)
            chans.append(ch)
        if level != len(arch.channel_mult) - 1:
            inputs.append([("down", ch, ch, res)])
            chans.append(ch)
            ds, res = ds * 2, res // 2
    middle = [("res", ch, ch, res), ("attn", ch, ch, res), ("res", ch, ch, res)]
    outputs: List[list] = []
    for level, mult in list(enumerate(arch.channel_mult))[::-1]:
        for i in range(arch.num_res_blocks + 1):
            block = [("res", ch + chans.pop(), mult * mc, res)]
            ch = mult * mc
            if ds in arch.attention_ds:
                block.append(("attn", ch, ch, res))
            if level and i == arch.num_res_blocks:
                block.append(("up", ch, ch, res))
                ds, res = ds // 2, res * 2
            outputs.append(block)
    return inputs, middle, outputs


def _plain(t):
    return t


class Norm(nn.Module):
    """GroupNorm(32) with fp32 statistics."""

    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.group_norm(x.float(), 32, self.weight, self.bias, 1e-5)


class Conv(nn.Conv2d):
    def forward(self, x):
        q = getattr(self, "quant", None) or _plain
        return F.conv2d(q(x), q(self.weight), self.bias, self.stride, self.padding)


class Dense(nn.Linear):
    def forward(self, x):
        q = getattr(self, "quant", None) or _plain
        return F.linear(q(x), q(self.weight), self.bias)


class Conv1x1(nn.Conv1d):
    """guided-diffusion's 1x1 ``conv_nd(1, ...)`` on [B, C, T]."""

    def forward(self, x):
        q = getattr(self, "quant", None) or _plain
        return F.conv1d(q(x), q(self.weight), self.bias)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_ch, up=False, down=False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(Norm(cin), nn.SiLU(), Conv(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_ch, 2 * cout))
        self.out_layers = nn.Sequential(Norm(cout), nn.SiLU(), nn.Identity(),
                                        Conv(cout, cout, 3, padding=1))
        self.skip_connection = nn.Identity() if cin == cout else Conv(cin, cout, 1)

    def forward(self, x, emb):
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h, x = F.interpolate(h, scale_factor=2, mode="nearest"), F.interpolate(
                x, scale_factor=2, mode="nearest")
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers(emb)[:, :, None, None].chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = self.out_layers[3](F.silu(h))
        return self.skip_connection(x) + h


class Attention(nn.Module):
    """Self-attention over the HW positions, guided-diffusion's legacy QKV
    order: the qkv channels split head by head, then into q, k, v."""

    def __init__(self, ch, head_ch):
        super().__init__()
        self.heads = ch // head_ch
        self.norm = Norm(ch)
        self.qkv = Conv1x1(ch, 3 * ch, 1)
        self.proj_out = Conv1x1(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        q8 = getattr(self, "quant", None) or _plain
        qkv = self.qkv(self.norm(x).reshape(b, c, hh * ww))
        q, k, v = qkv.reshape(b * self.heads, 3 * c // self.heads, hh * ww).chunk(3, dim=1)
        scale = 1 / math.sqrt(math.sqrt(c // self.heads))
        w = torch.einsum("bct,bcs->bts", q8(q * scale), q8(k * scale)).softmax(dim=-1)
        a = torch.einsum("bts,bcs->bct", q8(w), q8(v)).reshape(b, c, hh * ww)
        return x + self.proj_out(a).reshape(b, c, hh, ww)


def timestep_embedding(t, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNet(nn.Module):
    def __init__(self, arch: Arch):
        super().__init__()
        self.arch = arch
        emb_ch = 4 * arch.model_channels
        self.time_embed = nn.Sequential(Dense(arch.model_channels, emb_ch), nn.SiLU(),
                                        Dense(emb_ch, emb_ch))

        def make(kind, cin, cout, _res):
            if kind == "conv_in":
                return Conv(cin, cout, 3, padding=1)
            if kind == "attn":
                return Attention(cout, arch.num_head_channels)
            return ResBlock(cin, cout, emb_ch, up=kind == "up", down=kind == "down")

        inputs, middle, outputs = plan(arch)
        self.input_blocks = nn.ModuleList(nn.ModuleList(make(*l) for l in b) for b in inputs)
        self.middle_block = nn.ModuleList(make(*l) for l in middle)
        self.output_blocks = nn.ModuleList(nn.ModuleList(make(*l) for l in b) for b in outputs)
        ch = arch.channel_mult[0] * arch.model_channels
        self.out = nn.Sequential(Norm(ch), nn.SiLU(), Conv(ch, arch.out_channels, 3, padding=1))

    def set_quant(self, quant: Quant):
        for m in self.modules():
            if isinstance(m, (Conv, Dense, Conv1x1, Attention)):
                m.quant = quant
        return self

    def forward(self, x_nhwc, timesteps):
        emb = self.time_embed(timestep_embedding(timesteps, self.arch.model_channels))
        h = x_nhwc.permute(0, 3, 1, 2).float()
        hs = []

        def run(layer, h):
            return layer(h, emb) if isinstance(layer, ResBlock) else layer(h)

        for block in self.input_blocks:
            for layer in block:
                h = run(layer, h)
            hs.append(h)
        for layer in self.middle_block:
            h = run(layer, h)
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for layer in block:
                h = run(layer, h)
        return self.out[2](F.silu(self.out[0](h))).permute(0, 2, 3, 1)
