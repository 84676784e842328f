"""ADM UNet (guided-diffusion architecture) as a PyTorch module.

Port of ``osmosis_tpu/models/unet.py``: the same architecture plan
(:func:`build_plan`), the osmosis 4-in / 8-out RGBD head, scale-shift (FiLM)
GroupNorm, in-block resampling (``resblock_updown``), attention with the
legacy head-major QKV split, zero-initialized output projections, fp32
GroupNorm statistics and fp32 softmax.

Module names are the reference torch names (``time_embed.0/2``,
``input_blocks.{i}.{j}.in_layers.0/2``, ``emb_layers.1``, ``out_layers.0/3``,
``skip_connection``, ``qkv``, ``norm``, ``proj_out``, ``middle_block.*``,
``output_blocks.*``, ``out.0/2``), so a reference ``osmosis_outdoor.pt``
loads with ``load_state_dict`` as it is.

``forward(x, t)`` takes and returns NHWC like the JAX model. Inside, tensors
are NCHW in ``channels_last`` memory: ``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is a free view of that layout, which cuDNN's convolutions and the
port's kernels read without a copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import parse_attention_resolutions, parse_channel_mult
from .nn import GroupNorm32, avg_pool_2x, timestep_embedding, upsample_nearest_2x, zero_module


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 256
    in_channels: int = 4
    model_channels: int = 256
    out_channels: int = 8
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 16, 32)
    dropout: float = 0.0  # inference-only pipeline: accepted, never applied
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    conv_resample: bool = True
    num_heads: int = 4
    num_head_channels: int = 64
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    use_new_attention_order: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    def heads_for(self, ch: int, upsample: bool = False) -> int:
        if self.num_head_channels != -1:
            if ch % self.num_head_channels:
                raise ValueError(f"{ch} channels do not split into heads of {self.num_head_channels}")
            return ch // self.num_head_channels
        if upsample and self.num_heads_upsample != -1:
            return self.num_heads_upsample
        return self.num_heads


def unet_config_from_yaml(unet_model: Dict[str, Any], **overrides) -> UNetConfig:
    """Reference ``unet_model`` config dict -> UNetConfig (``unet.py:66-98``):
    pretrain_model 'osmosis' forces the 4-in / 8-out head."""
    image_size = unet_model["image_size"]
    learn_sigma = unet_model.get("learn_sigma", False)
    if unet_model.get("pretrain_model", "") == "osmosis":
        in_ch, out_ch = 4, 8
    else:
        in_ch, out_ch = 3, (6 if learn_sigma else 3)
    cfg = dict(
        image_size=image_size,
        in_channels=in_ch,
        out_channels=out_ch,
        model_channels=unet_model.get("num_channels", 256),
        num_res_blocks=unet_model.get("num_res_blocks", 2),
        attention_resolutions=parse_attention_resolutions(
            unet_model.get("attention_resolutions", "16"), image_size
        ),
        dropout=unet_model.get("dropout", 0.0),
        channel_mult=parse_channel_mult(unet_model.get("channel_mult", ""), image_size),
        num_heads=unet_model.get("num_heads", 1),
        num_head_channels=unet_model.get("num_head_channels", -1),
        num_heads_upsample=unet_model.get("num_heads_upsample", -1),
        use_scale_shift_norm=unet_model.get("use_scale_shift_norm", False),
        resblock_updown=unet_model.get("resblock_updown", False),
        use_new_attention_order=unet_model.get("use_new_attention_order", False),
    )
    cfg.update(overrides)
    return UNetConfig(**cfg)


# ---------------------------------------------------------------------------
# Architecture plan — shared by the module and the checkpoint converter
# ---------------------------------------------------------------------------

def build_plan(cfg: UNetConfig):
    """Replay of the reference UNetModel.__init__'s block construction (a copy
    of ``osmosis_tpu.models.unet.build_plan``). Returns (input_blocks,
    middle_block, output_blocks) of layer descriptors whose (block, layer)
    indices are the torch module tree's ``input_blocks.{i}.{j}``."""
    chm = cfg.channel_mult
    ch = int(chm[0] * cfg.model_channels)
    input_blocks: List[List[dict]] = [[dict(kind="conv_in", out_ch=ch)]]
    input_chans = [ch]
    ds = 1
    for level, mult in enumerate(chm):
        for _ in range(cfg.num_res_blocks):
            out_ch = int(mult * cfg.model_channels)
            layers = [dict(kind="res", in_ch=ch, out_ch=out_ch)]
            ch = out_ch
            if ds in cfg.attention_resolutions:
                layers.append(dict(kind="attn", ch=ch, heads=cfg.heads_for(ch)))
            input_blocks.append(layers)
            input_chans.append(ch)
        if level != len(chm) - 1:
            if cfg.resblock_updown:
                input_blocks.append([dict(kind="res_down", in_ch=ch, out_ch=ch)])
            else:
                input_blocks.append([dict(kind="down", ch=ch)])
            input_chans.append(ch)
            ds *= 2

    middle_block = [
        dict(kind="res", in_ch=ch, out_ch=ch),
        dict(kind="attn", ch=ch, heads=cfg.heads_for(ch)),
        dict(kind="res", in_ch=ch, out_ch=ch),
    ]

    output_blocks: List[List[dict]] = []
    for level, mult in list(enumerate(chm))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            out_ch = int(cfg.model_channels * mult)
            layers = [dict(kind="res", in_ch=ch + ich, out_ch=out_ch)]
            ch = out_ch
            if ds in cfg.attention_resolutions:
                layers.append(
                    dict(kind="attn", ch=ch, heads=cfg.heads_for(ch, upsample=True))
                )
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    layers.append(dict(kind="res_up", in_ch=ch, out_ch=ch))
                else:
                    layers.append(dict(kind="up", ch=ch))
                ds //= 2
            output_blocks.append(layers)

    return input_blocks, middle_block, output_blocks


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResBlock(nn.Module):
    """ResBlock with FiLM scale-shift norm and in-block resampling
    (reference unet.py:222-335)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, use_scale_shift_norm: bool,
                 up: bool = False, down: bool = False, dropout: float = 0.0):
        super().__init__()
        self.out_ch = out_ch
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(GroupNorm32(in_ch), nn.SiLU(), _conv3x3(in_ch, out_ch))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch)
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch), nn.SiLU(), nn.Dropout(dropout),
            zero_module(_conv3x3(out_ch, out_ch)),
        )
        self.skip_connection = nn.Identity() if in_ch == out_ch else nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x, act="silu")
        if self.up:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        elif self.down:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb).to(h.dtype)
        if self.use_scale_shift_norm:
            film = (emb_out[:, : self.out_ch], emb_out[:, self.out_ch:])
            h = self.out_layers[0](h, film=film, act="silu")
        else:
            h = self.out_layers[0](h + emb_out[:, :, None, None], act="silu")
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Self-attention over the HW tokens (reference unet.py:338-433).

    q and k are each scaled by hc^-1/4 before the logits product, and the
    softmax runs in fp32. ``qkv`` and ``proj_out`` are 1x1 Conv1d modules as in
    the reference; their weights are applied as a matrix product on the
    [B, T, C] token view.
    """

    def __init__(self, channels: int, num_heads: int, use_new_attention_order: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.legacy = not use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_module(nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        t, heads = hh * ww, self.num_heads
        hc = c // heads
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, t, c)
        qkv = F.linear(tokens, self.qkv.weight[:, :, 0], self.qkv.bias)
        if self.legacy:  # head-major: channel = head*3*hc + part*hc + c
            q, k, v = qkv.view(b, t, heads, 3, hc).unbind(3)
        else:  # part-major: channel = part*C + head*hc + c
            q, k, v = qkv.view(b, t, 3, heads, hc).unbind(2)
        scale = 1.0 / math.sqrt(math.sqrt(hc))
        logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        a = torch.einsum("bhts,bshc->bthc", weights, v).reshape(b, t, c)
        proj = F.linear(a, self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + proj.view(b, hh, ww, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    """Stride-2 conv (or 2x2 average pool) downsampling (unet.py:192-219)."""

    def __init__(self, ch: int, use_conv: bool):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x) if self.op is not None else avg_pool_2x(x)


class Upsample(nn.Module):
    """Nearest 2x upsample plus an optional 3x3 conv (unet.py:160-189)."""

    def __init__(self, ch: int, use_conv: bool):
        super().__init__()
        self.conv = _conv3x3(ch, ch) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest_2x(x)
        return self.conv(x) if self.conv is not None else x


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class UNetModel(nn.Module):
    """The full UNet; ``forward`` mirrors the reference unet.py:713-742 on NHWC."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        emb_ch = cfg.time_embed_dim
        self.time_embed = nn.Sequential(
            nn.Linear(cfg.model_channels, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch)
        )

        def make(lay: dict) -> nn.Module:
            kind = lay["kind"]
            if kind == "conv_in":
                return _conv3x3(cfg.in_channels, lay["out_ch"])
            if kind in ("res", "res_down", "res_up"):
                return ResBlock(
                    lay["in_ch"], lay["out_ch"], emb_ch, cfg.use_scale_shift_norm,
                    up=kind == "res_up", down=kind == "res_down", dropout=cfg.dropout,
                )
            if kind == "attn":
                return AttentionBlock(lay["ch"], lay["heads"], cfg.use_new_attention_order)
            if kind == "down":
                return Downsample(lay["ch"], cfg.conv_resample)
            if kind == "up":
                return Upsample(lay["ch"], cfg.conv_resample)
            raise ValueError(kind)

        input_blocks, middle_block, output_blocks = build_plan(cfg)
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(make(lay) for lay in block) for block in input_blocks
        )
        self.middle_block = nn.ModuleList(make(lay) for lay in middle_block)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(make(lay) for lay in block) for block in output_blocks
        )
        ch = output_blocks[-1][-1]["out_ch"]
        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(), zero_module(_conv3x3(ch, cfg.out_channels))
        )

    @staticmethod
    def _run_layer(layer: nn.Module, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return layer(h, emb) if isinstance(layer, ResBlock) else layer(h)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """``x`` NHWC [B, H, W, in_channels], ``timesteps`` [B] -> NHWC
        [B, H, W, out_channels]."""
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels))
        h = x.permute(0, 3, 1, 2)
        hs = []
        for block in self.input_blocks:
            for layer in block:
                h = self._run_layer(layer, h, emb)
            hs.append(h)
        for layer in self.middle_block:
            h = self._run_layer(layer, h, emb)
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for layer in block:
                h = self._run_layer(layer, h, emb)
        h = self.out[0](h.float(), act="silu")
        h = self.out[2](h)
        return h.permute(0, 2, 3, 1)
