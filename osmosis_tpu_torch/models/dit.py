"""DiT (Peebles and Xie, "Scalable Diffusion Models with Transformers", ICCV
2023, arXiv:2212.09748) as the RGBD prior of the guided chain.

Written from ``facebookresearch/DiT`` ``models.py``: a patch embedding, a
fixed 2-D sin-cos position table, a 256-frequency timestep embedder (cos
first), ``depth`` adaLN-Zero blocks (``SiLU -> Linear(hidden, 6 hidden)`` of
the conditioning gives shift, scale and gate for the attention branch and
for the MLP branch; ``LayerNorm(elementwise_affine=False, eps=1e-6)``, then
``x (1 + scale) + shift``; timm's ``Attention`` with a qkv bias and its
``Mlp`` with GELU-tanh), and a final adaLN layer (shift and scale) with a
``Linear(hidden, p^2 out)``. ``learn_sigma`` gives 8 channels out of 4: eps,
then the learned-range variance values, the Osmosis UNet's own I/O.

Departures from the published model:
  * unconditional: no ``y_embedder``; the conditioning is the timestep's
    embedding alone, as the Osmosis prior is unconditional;
  * pixel space: the 4-channel RGBD image itself, not VAE latents, patched
    at ``patch_size`` (DiT-XL/4 at 256^2: 4096 tokens).

Parameter names are DiT's own (``x_embedder.proj``, ``t_embedder.mlp.{0,2}``,
``blocks.{i}.attn.{qkv,proj}``, ``blocks.{i}.mlp.{fc1,fc2}``,
``blocks.{i}.adaLN_modulation.1``, ``final_layer.{adaLN_modulation.1,
linear}``, and ``pos_embed``, a fixed buffer), so a DiT state dict without
``y_embedder.*`` loads with ``load_state_dict(strict=True)``.

``forward(x, t)`` takes and returns NHWC like the UNet: x [B, H, W, 4] and
timesteps [B] to [B, H, W, 8]. Patches are cut and put back by views of the
NHWC tensor; the patch embedding is the ``Conv2d`` weight applied as one
matrix product.

The forward is written for few launches: the conditioning's SiLU once for
every block; each block's modulation one product, its fp32 copy and its two
``1 + scale`` in one op; each modulate one ``addcmul`` after the LayerNorm,
and each gated residual one ``addcmul``. On a card a call without grad (the
chain's x0-hat steps, every step outside the guidance window) replays a CUDA
graph of the whole forward, captured at the first such call of each input
shape: the host launches one graph in place of some 600 kernels, so the card
sets the pace. A call with grad (the x_prev steps, whose pullback walks the
forward's graph) runs eagerly.

``DiTConfig.dtype`` is the torso dtype. In bfloat16 (every parameter and
the position table cast by :func:`load_dit`) the rule is the UNet's with
LayerNorm in GroupNorm's place: the input and the time embedding's first
linear take bf16, every linear and the attention run in bf16 (the softmax
inside ``F.scaled_dot_product_attention`` keeps fp32 statistics), the
LayerNorm statistics and the modulation after them are fp32 with the
result cast to bf16, and the final layer's LayerNorm and linear run in fp32
on its bf16-rounded weights. The model's output is fp32 either way.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from .convert import CheckpointMismatch
from .nn import timestep_embedding

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    image_size: int = 256
    patch_size: int = 4
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    frequency_embedding_size: int = 256
    learn_sigma: bool = True
    dtype: torch.dtype = torch.float32  # the torso dtype: float32 or bfloat16

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(f"patch {self.patch_size} does not tile {self.image_size}")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"{self.hidden_size} does not split into {self.num_heads} heads")
        if self.hidden_size % 4:
            raise ValueError("the 2-D sin-cos table needs a hidden size divisible by 4")

    @property
    def out_channels(self) -> int:
        return 2 * self.in_channels if self.learn_sigma else self.in_channels

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


def dit_config_from_yaml(dit_model: Dict[str, Any], **overrides) -> DiTConfig:
    """A preset's ``dit_model`` section -> DiTConfig."""
    keys = [f.name for f in dataclasses.fields(DiTConfig) if f.name != "dtype"]
    cfg = {k: dit_model[k] for k in keys if k in dit_model}
    cfg.update(overrides)
    return DiTConfig(**cfg)


def sincos_pos_embed(hidden: int, grid: int) -> torch.Tensor:
    """DiT's ``get_2d_sincos_pos_embed`` (MAE's), [grid^2, hidden] fp32 from
    float64: the first half of the channels encodes the column, the second
    the row, each as [sin, cos] of 10000^(-k / (hidden / 4))."""
    omega = 1.0 / 10000 ** (torch.arange(hidden // 4, dtype=torch.float64) / (hidden / 4))
    coord = torch.arange(grid, dtype=torch.float64)
    col = coord.repeat(grid)                # token r * grid + c -> c
    row = coord.repeat_interleave(grid)     # -> r

    def one_axis(pos):
        out = pos[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([one_axis(col), one_axis(row)], dim=1).float()


def _norm_modulate(x: torch.Tensor, shift: torch.Tensor, scale1: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, fp32 statistics, then ``x (1 + scale) +
    shift`` from the fp32 ``shift`` and ``scale1 = 1 + scale`` [B, 1, H];
    fp32 out."""
    return torch.addcmul(shift, F.layer_norm(x.float(), (x.shape[-1],), eps=EPS), scale1)


def _modulation(linear: nn.Linear, silu_c: torch.Tensor, parts: int):
    """The adaLN modulation of ``SiLU(c)``: its ``parts`` chunks in the
    torso dtype, [B, parts, 1, H] (the gates are read here), their fp32 copy,
    and ``1 + scale`` of each (shift, scale[, gate]) group in fp32."""
    b, h = silu_c.shape[0], linear.in_features
    mod = F.linear(silu_c, linear.weight, linear.bias).view(b, parts, 1, h)
    m = mod.float()
    return mod, m, m[:, 1::3] + 1


class PatchEmbed(nn.Module):
    """timm's ``PatchEmbed`` (its ``proj`` Conv2d, kernel and stride p) on
    NHWC: each patch's (channel, row, column) values against the conv's
    weight as one matrix."""

    def __init__(self, patch: int, in_channels: int, hidden: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_channels, hidden, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, size, _, c = x.shape
        p, n = self.patch, size // self.patch
        cols = x.reshape(b, n, p, n, p, c).permute(0, 1, 3, 5, 2, 4).reshape(b, n * n, c * p * p)
        return F.linear(cols, self.proj.weight.view(self.proj.out_channels, -1), self.proj.bias)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int, frequency_embedding_size: int):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(nn.Linear(frequency_embedding_size, hidden), nn.SiLU(),
                                 nn.Linear(hidden, hidden))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.frequency_embedding_size).to(dtype))


class Attention(nn.Module):
    """timm's ``Attention``: qkv with a bias, its channels (part, head, dim);
    the attention itself in ``F.scaled_dot_product_attention`` under a
    ``dit.attention`` span."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        qkv = F.linear(x, self.qkv.weight, self.qkv.bias)
        q, k, v = qkv.view(b, t, 3, self.heads, h // self.heads).permute(2, 0, 3, 1, 4)
        with profiling.span("dit.attention"):
            a = F.scaled_dot_product_attention(q, k, v)
        return F.linear(a.transpose(1, 2).reshape(b, t, h), self.proj.weight, self.proj.bias)


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(F.linear(x, self.fc1.weight, self.fc1.bias), approximate="tanh")
        return F.linear(y, self.fc2.weight, self.fc2.bias)


class DiTBlock(nn.Module):
    """An adaLN-Zero block."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.attn = Attention(h, cfg.num_heads)
        self.mlp = Mlp(h, cfg.mlp_hidden)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(h, 6 * h))

    def forward(self, x: torch.Tensor, silu_c: torch.Tensor) -> torch.Tensor:
        """``silu_c``: SiLU of the conditioning, the same for every block."""
        mod, m, scale1 = _modulation(self.adaLN_modulation[1], silu_c, 6)
        a = self.attn(_norm_modulate(x, m[:, 0], scale1[:, 0]).to(x.dtype))
        x = torch.addcmul(x, mod[:, 2], a)
        y = self.mlp(_norm_modulate(x, m[:, 3], scale1[:, 1]).to(x.dtype))
        return torch.addcmul(x, mod[:, 5], y)


class FinalLayer(nn.Module):
    """The final adaLN layer, computed in fp32 on the stored weights."""

    def __init__(self, hidden: int, patch: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden, patch * patch * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 2 * hidden))

    def forward(self, x: torch.Tensor, silu_c: torch.Tensor) -> torch.Tensor:
        _, m, scale1 = _modulation(self.adaLN_modulation[1], silu_c, 2)
        return F.linear(_norm_modulate(x, m[:, 0], scale1[:, 0]), self.linear.weight.float(),
                        self.linear.bias.float())


class DiTModel(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, h)
        self.t_embedder = TimestepEmbedder(h, cfg.frequency_embedding_size)
        self.register_buffer("pos_embed", sincos_pos_embed(h, cfg.grid)[None])
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(h, cfg.patch_size, cfg.out_channels)
        self._graphs: Dict[tuple, _Graph] = {}

    def initialize_weights(self):
        """DiT's ``initialize_weights``: xavier-uniform linears with zero
        biases, the patch embedding likewise on its flattened weight, the
        timestep MLP's weights N(0, 0.02), and adaLN-Zero: every modulation
        and the final linear zero."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)
        w = self.x_embedder.proj.weight.data
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.zeros_(self.x_embedder.proj.bias)
        for i in (0, 2):
            nn.init.normal_(self.t_embedder.mlp[i].weight, std=0.02)
        for block in self.blocks:
            nn.init.zeros_(block.adaLN_modulation[-1].weight)
            nn.init.zeros_(block.adaLN_modulation[-1].bias)
        for m in (self.final_layer.adaLN_modulation[-1], self.final_layer.linear):
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)

    def _apply(self, fn, *args, **kwargs):
        self._graphs = {}  # a cast or a move makes new weights: capture again
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """``x`` NHWC [B, H, W, in_channels], ``timesteps`` [B] -> NHWC
        [B, H, W, out_channels] fp32. Counts ``dit.calls``; a ``dit.forward``
        span under ``utils/profiling.tracing()``, and in an eager call a
        ``dit.attention`` span around each block's attention. Without grad on
        a card it replays the input shape's CUDA graph (:class:`_Graph`)."""
        profiling.count("dit.calls")
        with profiling.span("dit.forward", batch=x.shape[0]):
            if not x.is_cuda or torch.is_grad_enabled():
                return self._forward(x, timesteps)
            key = (tuple(x.shape), x.dtype, tuple(timesteps.shape), timesteps.dtype, x.device)
            if key not in self._graphs:
                self._graphs[key] = _Graph(self._forward, x, timesteps)
            return self._graphs[key](x, timesteps)

    def _forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        h = self.x_embedder(x.to(dt)) + self.pos_embed
        silu_c = F.silu(self.t_embedder(timesteps, dt))
        for block in self.blocks:
            h = block(h, silu_c)
        out = self.final_layer(h, silu_c)  # [B, T, p p out], (row, column, channel)
        b, n, p = x.shape[0], cfg.grid, cfg.patch_size
        out = out.view(b, n, n, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, cfg.image_size, cfg.image_size, cfg.out_channels)


class _Graph:
    """A CUDA graph of ``fn`` (the grad-free forward) at one input shape,
    captured after two calls on a side stream (cuBLAS's and cuDNN's plans).
    A call copies its inputs into the graph's own, replays it, and returns a
    copy of its output, which no later replay overwrites."""

    def __init__(self, fn, x: torch.Tensor, t: torch.Tensor):
        self.x, self.t = x.clone(), t.clone()
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            fn(self.x, self.t)
            fn(self.x, self.t)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(self.x, self.t)

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        self.x.copy_(x)
        self.t.copy_(t)
        self.graph.replay()
        return self.out.clone()


def init_dit(cfg: DiTConfig, seed: int = 0) -> DiTModel:
    """A fp32 DiT with DiT's own init from ``seed``, built on the CPU
    without touching the global random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DiTModel(dataclasses.replace(cfg, dtype=torch.float32))
        model.initialize_weights()
    return model


def load_dit(model_path: Optional[str], cfg: DiTConfig, device, seed: int = 0,
             dtype: Optional[torch.dtype] = None) -> DiTModel:
    """The DiT on ``device``, weights frozen: a state dict in DiT's names at
    ``model_path`` loaded strictly, or DiT's seeded init where no file is
    there. A file that does not fit ``cfg`` raises
    :class:`CheckpointMismatch`. ``dtype`` (default ``cfg.dtype``) is the
    torso dtype; a bfloat16 torso casts every parameter and the position
    table."""
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
    model = init_dit(cfg, seed)
    if model_path and os.path.exists(model_path):
        state = torch.load(model_path, map_location="cpu", weights_only=True)
        try:
            model.load_state_dict(state)
        except RuntimeError as e:
            raise CheckpointMismatch(f"{model_path} does not fit the DiT config: {e}") from e
    else:
        print(f"No DiT checkpoint at {model_path!r} / Randomly initialize")
    model.cfg = cfg
    model.requires_grad_(False).eval()
    return model.to(device=device, dtype=cfg.dtype)
