"""Guided (osmosis) sampling: the reverse chain with physics guidance (port of
``osmosis_tpu/diffusion/guided.py``; reference gaussian_diffusion.py:179-340
and condition_methods.py:61-231).

Each step of the main path (``osmosis_guided``, guided.py:372-448) runs:
  1. the UNet forward on x with autograd on (weights frozen), giving x0-hat
     and the learned variance;
  2. ``n_iter - 1`` phi-only optimizer steps against a detached x0-hat,
     skipped where the pcgs pattern freezes phi;
  3. the joint gradient of the guidance loss with respect to (x0-hat, phi),
     the phi update (again only where phi is not frozen), and ONE pullback of
     the x0-hat cotangent through the UNet to x, clipped to
     ±``gradient_clip_value``;
  4. ``x_{t-1} = mean - scale·grad``, then noise after guidance,
     ``x + [t>0]·exp(½·logvar)·z``.

The pcgs masks are numpy arrays read on the host, so no step waits on the
device for a branch. Traces (per-step loss, phi, aux losses, x0-hat std)
stay on the device until the chain ends. Configurations outside this path
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import parse_gradient_clip, parse_scale, parse_weight_function
from ..guidance.losses import make_aux_loss_fn
from ..guidance.operators import Operator, convert_depth
from ..guidance.phi_optim import make_phi_optimizer
from ..guidance.schedule_masks import pattern_masks
from ..registry import CONDITIONERS
from .sampler import (
    SamplerConfig,
    device_constants,
    make_slot_map,
    model_log_variance,
    posterior_mean,
    predict_xstart,
    process_xstart,
    record_steps_for,
    record_update,
    split_model_output,
)
from .schedules import DiffusionSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x NHWC, t [B]) -> out
NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]  # (t, shape) -> z

CONDITIONERS.register("osmosis")("osmosis")
CONDITIONERS.register("ps")("ps")

_MODES_ITEM = "ROADMAP.md queue 1, item 2 (guidance modes)"


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """conditioning.params + sample_pattern surface (condition_methods.py:63-107)."""

    method: str = "osmosis"
    scale: Tuple[float, ...] = (1.0,)
    gradient_x_prev: bool = False
    x_prev_every: int = 1
    noiser_name: str = "gaussian"
    gradient_clip: bool = False
    gradient_clip_value: float = 0.0
    loss_function: str = "norm"  # 'norm' | 'mse'
    loss_weight: Optional[str] = None  # 'depth' | 'none'
    weight_function: Optional[str] = None  # e.g. "gamma,1.4,1.4,1"
    n_iter: int = 1
    aux_loss: Tuple[Tuple[str, float], ...] = ()

    @classmethod
    def from_config(cls, method: str, params: dict, sample_pattern: dict,
                    aux_loss_cfg: Optional[dict],
                    noiser_name: str = "gaussian") -> "GuidanceConfig":
        clip_on, clip_val = parse_gradient_clip(params.get("gradient_clip", "False"))
        aux = ()
        if aux_loss_cfg:
            inner = aux_loss_cfg.get("aux_loss") if "aux_loss" in aux_loss_cfg else aux_loss_cfg
            if inner:
                aux = tuple((k, float(v)) for k, v in inner.items())
        CONDITIONERS.get(method)  # unknown names fail fast, like the reference
        return cls(
            method=method,
            scale=tuple(float(s) for s in parse_scale(params.get("scale", 1.0))),
            gradient_x_prev=bool(params.get("gradient_x_prev", False)),
            x_prev_every=int(params.get("x_prev_every", 1)),
            gradient_clip=clip_on,
            gradient_clip_value=clip_val,
            loss_function=params.get("loss_function", "norm"),
            loss_weight=params.get("loss_weight"),
            weight_function=params.get("weight_function"),
            n_iter=int((sample_pattern or {}).get("n_iter", 1)),
            aux_loss=aux,
            noiser_name=noiser_name,
        )


@dataclasses.dataclass
class GuidedResult:
    sample: torch.Tensor            # final x (the chain's output after noise)
    pred_xstart: torch.Tensor       # x0-hat at the final step: what gets saved
    phi: Dict[str, torch.Tensor]    # final water parameters [B, C]
    sep_loss: torch.Tensor          # [T, B] per-image guidance loss
    phi_trace: Dict[str, torch.Tensor]  # [T, B, C]
    aux_trace: Dict[str, torch.Tensor]  # [T]
    x0_std_trace: torch.Tensor      # [T, B] x0-hat amplitude
    opt_state: dict                 # final phi-optimizer state (global_N warm starts)
    x0_snapshots: Optional[torch.Tensor] = None  # [K, B, H, W, 4]
    snapshot_steps: Tuple[int, ...] = ()

    @property
    def snapshots(self) -> Optional[dict]:
        if self.x0_snapshots is None:
            return None
        return {"steps": self.snapshot_steps, "x0_hat": self.x0_snapshots}


def _check_supported(gcfg: GuidanceConfig, scfg: SamplerConfig, masks: Dict[str, np.ndarray]):
    unsupported = [
        (gcfg.method != "osmosis", f"conditioning method '{gcfg.method}'"),
        (not gcfg.gradient_x_prev, "the x0-hat gradient mode (gradient_x_prev: False)"),
        (gcfg.x_prev_every > 1, "the hybrid gradient schedule (x_prev_every > 1)"),
        (scfg.sampler != "ddpm", f"sampler '{scfg.sampler}'"),
        (bool((masks["alternate_len"] != 1).any()), "local_M > 1 alternation"),
        (bool(masks["phi_warmup"].any()), "the phi warm phase (phi_warmup_iters)"),
        (not bool(masks["guidance"].all()), "an unguided window (start/stop_guidance)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: {_MODES_ITEM}")
    if gcfg.loss_function not in ("norm", "mse"):
        raise NotImplementedError(gcfg.loss_function)


def _make_weight_fn(gcfg: GuidanceConfig):
    """set_loss_weight (utils.py:674-700): depth-derived weights on the
    guidance difference, always from a detached x0-hat."""
    if gcfg.loss_weight in (None, "none"):
        return lambda x0: 1.0
    if gcfg.loss_weight == "depth":
        fn_str, value = parse_weight_function(gcfg.weight_function)
        return lambda x0: convert_depth(x0[..., 3:4].detach(), fn_str, value)
    raise NotImplementedError(gcfg.loss_weight)


def guided_sample_loop(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    measurement: torch.Tensor,
    operator: Operator,
    gcfg: GuidanceConfig,
    scfg: SamplerConfig = SamplerConfig(),
    sample_pattern: Optional[dict] = None,
    record_every: Optional[int] = None,
    deterministic: bool = False,
    phi_init: Optional[Dict[str, torch.Tensor]] = None,
    opt_state_init: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
) -> GuidedResult:
    """Run the guided reverse process over the whole chain. Tensors NHWC.

    ``deterministic=True`` adds no noise (the chain follows posterior means).
    Otherwise each step's noise is ``noise_fn(t, shape)`` when given (tests
    feed the JAX package's draws through it), else a standard normal draw
    from ``generator``. ``phi_init``/``opt_state_init`` warm-start phi and its
    optimizer state (global_N > 1 restarts).
    """
    T = schedule.num_timesteps
    B = x_init.shape[0]
    device = x_init.device
    masks = pattern_masks(sample_pattern, T)
    _check_supported(gcfg, scfg, masks)
    if not deterministic and noise_fn is None:
        if generator is None:
            raise ValueError("a stochastic chain needs a generator or a noise_fn")

        def noise_fn(t, shape):
            return torch.randn(shape, generator=generator, device=device, dtype=x_init.dtype)

    consts = device_constants(schedule, device)
    aux_fn = make_aux_loss_fn(dict(gcfg.aux_loss))
    aux_names = [k for k, _ in gcfg.aux_loss]
    weight_fn = _make_weight_fn(gcfg)
    scale = torch.tensor(gcfg.scale, dtype=torch.float32, device=device)
    scale = scale[0] if scale.numel() == 1 else scale.reshape(1, 1, 1, -1)

    src = phi_init if phi_init is not None else operator.phi_init()
    phi = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in src.items()}
    opt = make_phi_optimizer(operator.optimizer, operator.etas())
    opt_state = opt_state_init if opt_state_init is not None else opt.init(phi)
    y = measurement

    def loss_terms(x0, phi_):
        degraded = 2.0 * operator.forward(phi_, x0) - 1.0
        diff = ((y - degraded) * weight_fn(x0)).float()
        if gcfg.loss_function == "norm":
            loss = torch.sqrt(torch.sum(diff ** 2))
            sep = torch.sqrt(torch.sum(diff ** 2, dim=(1, 2, 3)))
        else:
            sep = torch.mean(diff ** 2, dim=(1, 2, 3))
            loss = torch.sum(sep)
        aux = {}
        if aux_fn is not None:
            aux_total, aux = aux_fn(x0)
            loss = loss + aux_total
        return loss, sep, aux

    def grads(x0, phi_, wrt_x0: bool):
        """Gradient of the guidance loss w.r.t. phi (and x0-hat), at leaves."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in phi_.items()}
        x0_leaf = x0.detach().requires_grad_(wrt_x0)
        with torch.enable_grad():
            total, sep, aux = loss_terms(x0_leaf, leaves)
            wrt = ([x0_leaf] if wrt_x0 else []) + list(leaves.values())
            gs = torch.autograd.grad(total, wrt)
        g_x0 = gs[0] if wrt_x0 else None
        g_phi = dict(zip(leaves, gs[1:] if wrt_x0 else gs))
        return g_x0, g_phi, sep.detach(), {k: aux[k].detach() for k in aux_names}

    if record_every is not None:
        rec_steps = record_steps_for(T, record_every, extra=(T - 1, 999))
        slot_map = make_slot_map(T, rec_steps)
        buf_x0 = torch.zeros((len(rec_steps),) + tuple(x_init.shape), dtype=x_init.dtype,
                             device=device)
    else:
        rec_steps, slot_map, buf_x0 = (), None, None

    seps, phis, auxs, stds = [], [], [], []
    x = x_init.detach()
    x0 = torch.zeros_like(x)
    for t in range(T - 1, -1, -1):
        tb = torch.full((B,), t, dtype=torch.long, device=device)
        freeze = bool(masks["freeze_phi"][t])
        xg = x.requires_grad_(True)
        with torch.enable_grad():
            eps, v = split_model_output(model_fn(xg, consts["model_timesteps"][tb]), x.shape[-1])
            x0_graph = process_xstart(predict_xstart(xg, tb, eps, consts, scfg), scfg)
        x0 = x0_graph.detach()
        logvar = model_log_variance(v.detach(), tb, consts, scfg)
        mean = posterior_mean(x0, x.detach(), tb, consts)

        if not freeze:  # inner phi-only iterations (condition_methods.py:193-194)
            for _ in range(gcfg.n_iter - 1):
                _, g_phi, _, _ = grads(x0, phi, wrt_x0=False)
                phi, opt_state = opt.update(phi, g_phi, opt_state)

        g_x0, g_phi, sep, aux_vec = grads(x0, phi, wrt_x0=True)
        if not freeze:
            phi, opt_state = opt.update(phi, g_phi, opt_state)

        # the one pullback through the UNet: the cotangent of x0-hat alone,
        # i.e. a zero cotangent for the variance channels
        (g_x,) = torch.autograd.grad(x0_graph, xg, g_x0)
        if gcfg.gradient_clip:
            g_x = torch.clamp(g_x, -gcfg.gradient_clip_value, gcfg.gradient_clip_value)
        x_t = mean - scale * g_x
        if deterministic or t == 0:
            x = x_t
        else:  # noise after guidance (gaussian_diffusion.py:266-268)
            x = x_t + torch.exp(0.5 * logvar) * noise_fn(t, tuple(x_t.shape))

        if slot_map is not None:
            record_update(buf_x0, x0, int(slot_map[t]))
        seps.append(sep)
        phis.append(phi)
        auxs.append(aux_vec)
        stds.append(x0.float().reshape(B, -1).std(dim=1, unbiased=False))

    return GuidedResult(
        sample=x.detach(),
        pred_xstart=x0,
        phi=phi,
        sep_loss=torch.stack(seps),
        phi_trace={k: torch.stack([p[k] for p in phis]) for k in phi},
        aux_trace={k: torch.stack([a[k] for a in auxs]) for k in aux_names},
        x0_std_trace=torch.stack(stds),
        opt_state=opt_state,
        x0_snapshots=buf_x0,
        snapshot_steps=tuple(rec_steps),
    )
