"""The diffusion samplers (port of ``osmosis_tpu/diffusion/sampler.py``):
x0-hat prediction and processing, the posterior mean, the four variance
types, the eps / variance split of the model output, the DDPM and DDIM steps,
snapshot recording, and :func:`sample_loop`, the unconditional reverse chain
of the prior sampler. All tensors are NHWC; per-timestep coefficients are
gathered from the schedule's fp32 constants.

Noise comes from a ``noise_fn(t, shape)`` where the caller gives one (tests
feed the JAX package's ``normal(fold_in(key, t))`` draws through it), else
from a ``torch.Generator``, whose bits differ from ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..registry import SAMPLERS

Consts = Dict[str, torch.Tensor]
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x NHWC, t [B]) -> out


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """create_sampler surface (gaussian_diffusion.py:38-62)."""

    sampler: str = "ddpm"  # 'ddpm' | 'ddim' | 'ltsp'
    model_mean_type: str = "epsilon"  # 'epsilon' | 'start_x' | 'previous_x'
    model_var_type: str = "learned_range"
    # 'learned_range' | 'learned' | 'fixed_small' | 'fixed_large'
    dynamic_threshold: bool = False
    clip_denoised: bool = False
    ddim_eta: float = 0.0


SAMPLERS.register("ddpm")("ddpm")
SAMPLERS.register("ddim")("ddim")
# 'ltsp': Lie-Trotter splitting with a PLMS4 diffusion substep, for guided
# sampling only (diffusion/guided.py)
SAMPLERS.register("ltsp")("ltsp")


def device_constants(schedule, device) -> Consts:
    """The schedule's fp32 per-timestep constants as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in schedule.device_constants().items()}


def dynamic_thresholding(x: torch.Tensor, s: float = 0.95) -> torch.Tensor:
    """util/img_utils.py:9-15, bug-compatible with the JAX package: the
    tensor is MULTIPLIED by the global |x| quantile, then clipped."""
    scaling = torch.quantile(x.abs().flatten().float(), s).to(x.dtype)
    return torch.clamp(x * scaling, -1.0, 1.0)


def process_xstart(x: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """posterior_mean_variance.py:43-50."""
    if cfg.dynamic_threshold:
        x = dynamic_thresholding(x, s=0.98)
    if cfg.clip_denoised:
        x = torch.clamp(x, -1.0, 1.0)
    return x


def _g(consts: Consts, name: str, t: torch.Tensor) -> torch.Tensor:
    """Per-timestep scalar for each batch item, shaped [B, 1, 1, 1]."""
    return consts[name][t].reshape(-1, 1, 1, 1)


def predict_xstart(x: torch.Tensor, t: torch.Tensor, model_output: torch.Tensor,
                   consts: Consts, cfg: SamplerConfig) -> torch.Tensor:
    """Mean-processor x0 prediction (posterior_mean_variance.py:53-136)."""
    if cfg.model_mean_type == "epsilon":
        return (
            _g(consts, "sqrt_recip_alphas_cumprod", t) * x
            - _g(consts, "sqrt_recipm1_alphas_cumprod", t) * model_output
        )
    if cfg.model_mean_type == "start_x":
        return model_output
    if cfg.model_mean_type == "previous_x":
        c1 = _g(consts, "posterior_mean_coef1", t)
        c2 = _g(consts, "posterior_mean_coef2", t)
        return model_output / c1 - (c2 / c1) * x
    raise NotImplementedError(cfg.model_mean_type)


def posterior_mean(x0: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                   consts: Consts) -> torch.Tensor:
    """q(x_{t-1} | x_t, x_0) mean (gaussian_diffusion.py:157-167)."""
    return _g(consts, "posterior_mean_coef1", t) * x0 + _g(consts, "posterior_mean_coef2", t) * x


def model_log_variance(var_values: torch.Tensor, t: torch.Tensor, consts: Consts,
                       cfg: SamplerConfig) -> torch.Tensor:
    """Variance processors (posterior_mean_variance.py:172-258), fp32."""
    v = var_values.float()
    if cfg.model_var_type == "learned_range":
        min_log = _g(consts, "posterior_log_variance_clipped", t)
        max_log = _g(consts, "log_betas", t)
        frac = (v + 1.0) / 2.0
        return frac * max_log + (1 - frac) * min_log
    if cfg.model_var_type == "learned":
        return v
    if cfg.model_var_type == "fixed_small":
        # the UNCLIPPED log variance (posterior_mean_variance.py:183-190);
        # -inf at t=0 is harmless because no noise is added there
        return torch.log(consts["posterior_variance"][t]).reshape(-1, 1, 1, 1).expand(v.shape)
    if cfg.model_var_type == "fixed_large":
        return _g(consts, "fixed_large_log_variance", t).expand(v.shape)
    raise NotImplementedError(cfg.model_var_type)


def split_model_output(model_output: torch.Tensor, x_channels: int):
    """Split eps / learned-variance channels (gaussian_diffusion.py:348-355)."""
    if model_output.shape[-1] == 2 * x_channels:
        return model_output[..., :x_channels], model_output[..., x_channels:]
    return model_output, model_output


def p_mean_variance(model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor, consts: Consts,
                    cfg: SamplerConfig, timestep_offset: float = 0.0) -> Dict[str, torch.Tensor]:
    """gaussian_diffusion.py:345-365. ``t`` is the respaced index [B]."""
    model_output = model_fn(x, consts["model_timesteps"][t] + timestep_offset)
    eps, var_values = split_model_output(model_output, x.shape[-1])
    x0 = process_xstart(predict_xstart(x, t, eps, consts, cfg), cfg)
    return {"mean": posterior_mean(x0, x, t, consts),
            "log_variance": model_log_variance(var_values, t, consts, cfg),
            "pred_xstart": x0}


def _nonzero(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return (t > 0).to(like.dtype).reshape(-1, 1, 1, 1)


def ddpm_noise_step(out: Dict[str, torch.Tensor], t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """mean + exp(½·logvar)·z, no noise at t == 0 (gaussian_diffusion.py:494-502)."""
    return out["mean"] + _nonzero(t, z) * torch.exp(0.5 * out["log_variance"]) * z


def ddim_step(x: torch.Tensor, out: Dict[str, torch.Tensor], t: torch.Tensor, z: torch.Tensor,
              consts: Consts, eta: float) -> torch.Tensor:
    """DDIM eq. 12 (gaussian_diffusion.py:505-535)."""
    x0 = out["pred_xstart"]
    eps = (_g(consts, "sqrt_recip_alphas_cumprod", t) * x - x0) / _g(
        consts, "sqrt_recipm1_alphas_cumprod", t)
    ab = _g(consts, "alphas_cumprod", t)
    ab_prev = _g(consts, "alphas_cumprod_prev", t)
    sigma = eta * torch.sqrt((1 - ab_prev) / (1 - ab)) * torch.sqrt(1 - ab / ab_prev)
    mean_pred = x0 * torch.sqrt(ab_prev) + torch.sqrt(1 - ab_prev - sigma ** 2) * eps
    return mean_pred + _nonzero(t, z) * sigma * z


# ---------------------------------------------------------------------------
# process recording
# ---------------------------------------------------------------------------

def record_steps_for(num_timesteps: int, record_every: int,
                     extra: Sequence[int] = ()) -> Tuple[int, ...]:
    """Timesteps whose x0-hat snapshot is kept: the reference's
    ``(idx % record_every == 0) or idx == 0 or idx == 999``, sorted
    descending (recording order)."""
    steps = {t for t in range(num_timesteps) if t % record_every == 0}
    steps.add(0)
    steps.update(e for e in extra if 0 <= e < num_timesteps)
    return tuple(sorted(steps, reverse=True))


def make_slot_map(num_timesteps: int, record_steps: Sequence[int]) -> np.ndarray:
    slot = np.full((num_timesteps,), -1, dtype=np.int32)
    for i, t in enumerate(record_steps):
        slot[t] = i
    return slot


def record_update(buf: torch.Tensor, value: torch.Tensor, slot: int) -> torch.Tensor:
    """Write ``value`` into snapshot slot ``slot`` of ``buf`` in place
    (-1 = skip); returns ``buf``."""
    if slot >= 0:
        buf[slot] = value
    return buf


# ---------------------------------------------------------------------------
# unconditional sampling loop (the prior path)
# ---------------------------------------------------------------------------

def sample_loop(
    model_fn: ModelFn,
    schedule,
    x_init: torch.Tensor,
    cfg: SamplerConfig = SamplerConfig(),
    timestep_offset: float = 0.0,
    start_t: Optional[int] = None,
    num_steps: Optional[int] = None,
    record_every: Optional[int] = None,
    record_steps: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
):
    """Reverse diffusion without guidance, the model under ``torch.no_grad``.

    With defaults this is DDPM ancestral sampling over the whole (respaced)
    chain. ``start_t``/``num_steps`` run the steps ``start_t - 1`` down to
    ``start_t - num_steps``: the prior sampler's "last N steps"
    (osmosis_utils/diffusion.py:74-80). Each step's noise is
    ``noise_fn(t, shape)`` when given, else a standard normal draw from
    ``generator``. Returns ``(x, snapshots)``; snapshots (None without
    recording) hold x_t and x0-hat at the recording steps.
    """
    T = schedule.num_timesteps
    start_t = T if start_t is None else start_t
    num_steps = start_t if num_steps is None else num_steps
    device = x_init.device
    if noise_fn is None:
        if generator is None:
            raise ValueError("sample_loop needs a generator or a noise_fn")

        def noise_fn(t, shape):
            return torch.randn(shape, generator=generator, device=device, dtype=x_init.dtype)

    consts = device_constants(schedule, device)
    if record_steps is not None or record_every is not None:
        if record_steps is not None:
            rec_steps = tuple(sorted(set(record_steps), reverse=True))
        else:
            rec_steps = record_steps_for(T, record_every, extra=(T - 1,))
        slot_map = make_slot_map(T, rec_steps)
        buf_xt = torch.zeros((len(rec_steps),) + tuple(x_init.shape), dtype=x_init.dtype,
                             device=device)
        buf_x0 = torch.zeros_like(buf_xt)
    else:
        rec_steps, slot_map = (), None

    x = x_init
    with torch.no_grad():
        for t in range(start_t - 1, start_t - num_steps - 1, -1):
            tb = torch.full((x.shape[0],), t, dtype=torch.long, device=device)
            out = p_mean_variance(model_fn, x, tb, consts, cfg, timestep_offset)
            z = noise_fn(t, tuple(x.shape))
            if cfg.sampler == "ddim":
                x_next = ddim_step(x, out, tb, z, consts, cfg.ddim_eta)
            else:
                x_next = ddpm_noise_step(out, tb, z)
            if slot_map is not None:
                record_update(buf_xt, x, int(slot_map[t]))
                record_update(buf_x0, out["pred_xstart"], int(slot_map[t]))
            x = x_next
    snapshots = None
    if slot_map is not None:
        snapshots = {"steps": rec_steps, "x_t": buf_xt, "x0_hat": buf_x0}
    return x, snapshots
