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

``UNetConfig.dtype`` is the torso dtype, as in the JAX model. In bfloat16
(parameters cast by ``convert.cast_params_half``) the casts follow the JAX
model's: the input and the time embedding's first linear take bf16, every
conv, linear and attention projection runs in bf16, the attention logits are
an fp32 product of bf16 q and k, the softmax is fp32, GroupNorm statistics
are fp32 with fp32 affines, and the torso's output is cast to fp32 before the
output norm and the output conv, which runs in fp32 on its bf16-rounded
weights. The model's output is fp32 either way.

On a card a call replays CUDA graphs (:class:`_Graphs`): one forward graph,
captured with grad on x, serves the grad-free calls and those whose
x-pullback follows, and a second graph is that pullback, which
``autograd.grad`` reaches through :class:`_Replay`. One pair is captured at
the first call of each input key (shapes, layouts, dtypes, devices and the
algorithm settings), so the host launches one graph in place of some 500
kernels a call (some 1000 for a forward and its pullback), and K1-K4,
cuDNN's convolutions and the attention run inside it as the eager call
runs them. :func:`takes_graph` names the calls that run eagerly instead:
off a card, with hooks, remat, a trained parameter or inside another
capture.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable
from torch.nn.modules import module as _module
from torch.utils.checkpoint import checkpoint

from ..config import parse_attention_resolutions, parse_channel_mult
from ..utils import profiling
from .nn import GroupNorm32, avg_pool_2x, timestep_embedding, upsample_nearest_2x, zero_module


_REQUIRES_GRAD = operator.attrgetter("requires_grad")


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
    dtype: torch.dtype = torch.float32  # the torso dtype: float32 or bfloat16
    # recompute each ResBlock and AttentionBlock in the backward instead of
    # keeping its activations (the JAX model's nn.remat, the config's
    # use_checkpoint): the same values, less memory, one more forward
    remat: bool = False

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
    pretrain_model 'osmosis' forces the 4-in / 8-out head; ``use_checkpoint``
    turns on ``remat``, as the JAX restore pipeline reads it."""
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
        remat=bool(unet_model.get("use_checkpoint", False)),
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


class TokenConv1d(nn.Conv1d):
    """A 1x1 ``nn.Conv1d`` (the reference's module and its [out, in, 1]
    weight) applied as a matrix product to a [B, T, C] token view."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.linear(tokens, self.weight[:, :, 0], self.bias)


class Float32Conv2d(nn.Conv2d):
    """The output conv: computed in fp32 on the stored weights (bf16-rounded
    in a bf16 model), as the JAX model does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.float(), self.weight.float(), self.bias.float())


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
    the reference (:class:`TokenConv1d`), applied as a matrix product on the
    [B, T, C] token view.
    """

    def __init__(self, channels: int, num_heads: int, use_new_attention_order: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.legacy = not use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = TokenConv1d(channels, 3 * channels, 1)
        self.proj_out = zero_module(TokenConv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        t, heads = hh * ww, self.num_heads
        hc = c // heads
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, t, c)
        qkv = self.qkv(tokens)
        if self.legacy:  # head-major: channel = head*3*hc + part*hc + c
            q, k, v = qkv.view(b, t, heads, 3, hc).unbind(3)
        else:  # part-major: channel = part*C + head*hc + c
            q, k, v = qkv.view(b, t, 3, heads, hc).unbind(2)
        scale = 1.0 / math.sqrt(math.sqrt(hc))
        if q.dtype != torch.float32:  # the scale rounded to q's dtype, as JAX has it
            scale = torch.tensor(scale, dtype=torch.float32).to(q.dtype).item()
        # an fp32 product of (bf16) q and k: the logits are never rounded
        logits = torch.einsum("bthc,bshc->bhts", (q * scale).float(), (k * scale).float())
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        a = torch.einsum("bhts,bshc->bthc", weights, v).reshape(b, t, c)
        proj = self.proj_out(a)
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
        last = output_blocks[-1][-1]  # a res layer, or attention where it comes last
        ch = last.get("out_ch", last.get("ch"))
        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(),
            zero_module(Float32Conv2d(ch, cfg.out_channels, 3, padding=1)),
        )
        self._graphs: Dict[tuple, _Graphs] = {}
        self._watched = None  # (hook tables, parameters): _graphable

    def _run_layer(self, layer: nn.Module, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        args = (h, emb) if isinstance(layer, ResBlock) else (h,)
        if (self.cfg.remat and torch.is_grad_enabled()
                and isinstance(layer, (ResBlock, AttentionBlock))):
            # the blocks draw no random numbers, so no RNG state is kept
            return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
        return layer(*args)

    def _apply(self, fn, *args, **kwargs):
        self._graphs, self._watched = {}, None  # a cast or a move: new weights, capture again
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._graphs, self._watched = {}, None  # the graphs read the parameters where they were
        return super().load_state_dict(*args, **kwargs)

    def _graphable(self, x: torch.Tensor, timesteps: torch.Tensor) -> bool:
        """Does this call take the CUDA graphs (:func:`takes_graph`)?"""
        return x.is_cuda and takes_graph(capturing=torch.cuda.is_current_stream_capturing(),
                                         **self._observe(timesteps))

    def _observe(self, timesteps: torch.Tensor) -> Dict[str, bool]:
        """What :func:`takes_graph` reads of the model and of the call, but
        the stream. The hook tables (the global ones and each
        module's) and the parameters are gathered once, and read at each
        call."""
        if self._watched is None:
            hooks = [_module._global_forward_hooks, _module._global_forward_pre_hooks,
                     _module._global_backward_hooks, _module._global_backward_pre_hooks]
            for m in self.modules():
                hooks += (m._forward_hooks, m._forward_pre_hooks, m._backward_hooks,
                          m._backward_pre_hooks)
            self._watched = tuple(hooks), tuple(self.parameters())
        hooks, params = self._watched
        return dict(hooked=any(hooks), remat=self.cfg.remat,
                    other_grads=timesteps.requires_grad or any(map(_REQUIRES_GRAD, params)))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """``x`` NHWC [B, H, W, in_channels], ``timesteps`` [B] -> NHWC
        [B, H, W, out_channels]. Counts ``unet.calls``; a ``unet.forward``
        span under ``utils/profiling.tracing()``. On a card, where
        :func:`takes_graph` allows it, the call replays the CUDA graphs of its
        input's key (:class:`_Graphs`), and its x-pullback replays theirs."""
        profiling.count("unet.calls")
        with profiling.span("unet.forward", batch=x.shape[0]):
            if not self._graphable(x, timesteps):
                return self._forward(x, timesteps)
            key = _graph_key(x, timesteps)
            graphs = self._graphs.get(key)
            if graphs is None:
                graphs = self._graphs[key] = _Graphs(self._forward, x, timesteps)
            if torch.is_grad_enabled() and x.requires_grad:
                return _Replay.apply(graphs, self._forward, x, timesteps)
            return graphs.forward(x, timesteps)

    def _forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels).to(dt))
        h = x.permute(0, 3, 1, 2).to(dt)
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
        h = self.out[2](self.out[0](h.float(), act="silu"))
        return h.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# CUDA graphs of the forward and its x-pullback
# ---------------------------------------------------------------------------

def takes_graph(*, hooked: bool, remat: bool, other_grads: bool, capturing: bool) -> bool:
    """Does a call on a card replay the CUDA graphs? Not where a replay
    would skip or break what the eager call does: a module of
    the model has hooks, or a global module hook is set (``hooked``:
    ``parallel/tp`` runs collectives in them, ``FlopCounterMode`` counts
    with them), ``remat`` recomputes blocks in the backward, a parameter or
    the timesteps want a gradient (``other_grads``: training), or the stream
    is already capturing a graph (``capturing``: ``utils/timing``)."""
    return not (hooked or remat or other_grads or capturing)


def _graph_key(x: torch.Tensor, t: torch.Tensor) -> tuple:
    """What a graph was captured for: the inputs' shapes, layouts, dtypes and
    devices, and the settings that pick cuDNN's and cuBLAS's algorithms."""
    return (tuple(x.shape), x.stride(), x.dtype, x.device, tuple(t.shape), t.dtype, t.device,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())


class _Graphs:
    """The forward ``fn(x, t)`` with grad on x and its x-pullback
    ``autograd.grad(out, x, g)``, captured as two CUDA graphs in one memory
    pool at one input key, after two eager calls of both on a side stream
    (cuDNN's and cuBLAS's plans). The pullback's capture keeps the autograd
    graph, so the forward's activations stay where the backward graph reads
    them and no later allocation takes their memory.

    Both kinds of call replay the one forward graph: a grad-free one and one
    whose pullback follows. Every replay copies its inputs into the graphs'
    own and returns a copy of the output or of the gradient, which no later
    replay overwrites. ``generation`` counts forward replays, so a pullback
    knows whether the activations are still its forward's.

    Counters: the build (warm-up calls and captures) counts nothing but
    ``unet.graph_captures``; each forward replay adds ``unet.graph_replays``
    and what the kernel wrappers counted during the forward's capture
    (``<wrapper>.launches``, ``.kernel_launches``), each pullback replay
    ``unet.graph_pullbacks`` and what they counted during its capture, so
    that the wrappers' counters read as the eager calls would. Not for
    concurrent calls from several threads."""

    def __init__(self, fn, x: torch.Tensor, t: torch.Tensor):
        dev = x.device
        before = profiling.counters()
        with torch.cuda.device(dev), torch.enable_grad():
            self.x = x.detach().clone().requires_grad_(True)
            self.t = t.detach().clone()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(2):
                    out = fn(self.x, self.t)
                    torch.autograd.grad(out, self.x, torch.zeros_like(out))
                del out
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = profiling.counters()
            self.fwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.fwd):
                self.out = fn(self.x, self.t)
            captured = profiling.counters()
            self.g = torch.empty_like(self.out)
            self.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.bwd, pool=self.fwd.pool()):
                (self.gx,) = torch.autograd.grad(self.out, self.x, self.g, retain_graph=True)
            done = profiling.counters()
        self.fwd_counts, self.bwd_counts = captured - warm, done - captured
        profiling.count_all({k: -n for k, n in (done - before).items()})
        profiling.count("unet.graph_captures")
        self.generation = 0

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), torch.cuda.device(self.x.device):
            self.x.copy_(x)
            self.t.copy_(t)
            self.fwd.replay()
        self.generation += 1
        profiling.count_all(self.fwd_counts)
        profiling.count("unet.graph_replays")
        return self.out.detach().clone()

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        with torch.cuda.device(self.x.device):
            self.g.copy_(g)
            self.bwd.replay()
        profiling.count_all(self.bwd_counts)
        profiling.count("unet.graph_pullbacks")
        return self.gx.clone()


class _Replay(torch.autograd.Function):
    """A graphed call with grad on x: the forward replays the forward graph,
    the backward the pullback's. A backward whose forward is no longer the
    graphs' newest replay (another forward ran in between) does not read
    their activations: it runs the forward again eagerly and pulls back
    through that."""

    @staticmethod
    def forward(ctx, graphs, fn, x, t):
        out = graphs.forward(x, t)
        ctx.graphs, ctx.fn, ctx.generation = graphs, fn, graphs.generation
        ctx.save_for_backward(x, t)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.generation == ctx.graphs.generation:
            return None, None, ctx.graphs.backward(g), None
        x, t = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(ctx.fn(xr, t), xr, g)
        return None, None, gx, None
