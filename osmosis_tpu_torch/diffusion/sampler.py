"""Per-step diffusion arithmetic of the samplers (port of
``osmosis_tpu/diffusion/sampler.py``): x0-hat prediction and processing, the
posterior mean, the four variance types, the eps / variance split of the
model output, and the x0-hat snapshot recording. All tensors are NHWC;
per-timestep coefficients are gathered from the schedule's fp32 constants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

Consts = Dict[str, torch.Tensor]


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
