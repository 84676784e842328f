"""Diffusion noise schedules and timestep respacing.

Behavioral contract comes from the reference implementation:
  * beta schedules: guided_diffusion/gaussian_diffusion.py:542-586
  * schedule coefficient arrays (float64): gaussian_diffusion.py:76-113
  * timestep respacing: gaussian_diffusion.py:373-450
  * variance processor constants: posterior_mean_variance.py:172-258

All coefficients are computed once on the host in float64 (the reference's
precision choice, gaussian_diffusion.py:76) and exported as fp32 tensors that
the sampler gathers by timestep index on the device. Pure numpy: a copy of
``osmosis_tpu/diffusion/schedules.py``, kept in the port so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Set, Union

import numpy as np


def linear_betas(num_timesteps: int) -> np.ndarray:
    """Ho et al. linear schedule, scaled for any T (gaussian_diffusion.py:551-559)."""
    scale = 1000 / num_timesteps
    beta_start = scale * 0.0001
    beta_end = scale * 0.02
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def betas_for_alpha_bar(num_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a cumulative alpha-bar function (gaussian_diffusion.py:569-586)."""
    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def cosine_betas(num_timesteps: int) -> np.ndarray:
    """Improved-DDPM cosine schedule (gaussian_diffusion.py:560-564)."""
    return betas_for_alpha_bar(
        num_timesteps,
        lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
    )


def get_named_beta_schedule(schedule_name: str, num_timesteps: int) -> np.ndarray:
    if schedule_name == "linear":
        return linear_betas(num_timesteps)
    if schedule_name == "cosine":
        return cosine_betas(num_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def space_timesteps(num_timesteps: int, section_counts: Union[str, int, Sequence[int]]) -> Set[int]:
    """Pick a subset of timesteps for a respaced process.

    Semantics match gaussian_diffusion.py:373-426 exactly, including the
    "ddimN" fixed-stride special case and the per-section fractional stride.
    One beyond-reference extension: "powN" / "powN@gamma" selects N steps
    with power-law density (see power_timesteps).
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("pow"):
            spec = section_counts[len("pow"):]
            gamma = 2.0
            if "@" in spec:
                spec, gamma_str = spec.split("@", 1)
                gamma = float(gamma_str)
            return power_timesteps(num_timesteps, int(spec), gamma)
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1.0
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


def power_timesteps(num_timesteps: int, count: int, gamma: float) -> Set[int]:
    """Non-uniform respacing: retained-step density follows a power law.

    Beyond-reference capability (the reference only exposes uniform strides
    and per-section counts, gaussian_diffusion.py:373-426). Motivated by the
    non-uniform skip strategies in the low-step-count sampling literature
    (e.g. arXiv 2309.03445's skip-sampling, EDM's rho-spacing): gamma > 1
    concentrates the retained timesteps at LOW noise (small t, where image
    detail forms and guidance gradients are most informative); gamma < 1
    concentrates them at high noise; gamma == 1 reproduces the uniform
    fractional-stride placement. Both endpoints (0 and T-1) are always
    retained, and rounding collisions are repaired to keep exactly `count`
    strictly increasing steps.

    MEASURED (VALIDATION.md 3g): for GUIDED restoration uniform spacing
    wins at every gamma tried (50 steps, 64px toy ladder: uniform +5.84 dB
    vs +1.93/+0.71/−0.70/+2.20 at gamma 1.5/2/3/0.5). gamma>1 starves
    high-noise structure formation; gamma<1 starves the pcgs phi-descent
    window. Experimental — keep presets on uniform strides.
    """
    if not 0 < count <= num_timesteps:
        raise ValueError(
            f"cannot take {count} power-spaced steps from {num_timesteps}")
    if gamma <= 0:
        raise ValueError(f"power-spacing exponent must be > 0, got {gamma}")
    u = np.linspace(0.0, 1.0, count)
    steps = np.round((u ** gamma) * (num_timesteps - 1)).astype(np.int64)
    for i in range(1, count):  # forward repair: strictly increasing
        if steps[i] <= steps[i - 1]:
            steps[i] = steps[i - 1] + 1
    if count > 1 and steps[-1] > num_timesteps - 1:  # backward: back in range
        steps[-1] = num_timesteps - 1
        for i in range(count - 2, -1, -1):
            if steps[i] >= steps[i + 1]:
                steps[i] = steps[i + 1] - 1
    return set(int(s) for s in steps)


def respace_betas(betas: np.ndarray, use_timesteps: Set[int]):
    """Remap betas onto the retained timesteps (gaussian_diffusion.py:437-451).

    Returns (new_betas, timestep_map) where timestep_map[i] is the original
    timestep fed to the model for respaced step i (gaussian_diffusion.py:484-489).
    """
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, alpha_cumprod in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep coefficient arrays, float64, host-resident.

    Field-for-field equivalent of the reference's precomputed arrays
    (gaussian_diffusion.py:76-113) plus the variance-processor constants
    (posterior_mean_variance.py:172-258). ``timestep_map`` is identity when
    no respacing is applied.
    """

    betas: np.ndarray
    timestep_map: np.ndarray
    rescale_timesteps: bool = False
    original_num_steps: int = 0

    # derived (filled by make_schedule)
    alphas_cumprod: np.ndarray = None
    alphas_cumprod_prev: np.ndarray = None
    alphas_cumprod_next: np.ndarray = None
    sqrt_alphas_cumprod: np.ndarray = None
    sqrt_one_minus_alphas_cumprod: np.ndarray = None
    log_one_minus_alphas_cumprod: np.ndarray = None
    sqrt_recip_alphas_cumprod: np.ndarray = None
    sqrt_recipm1_alphas_cumprod: np.ndarray = None
    posterior_variance: np.ndarray = None
    posterior_log_variance_clipped: np.ndarray = None
    posterior_mean_coef1: np.ndarray = None
    posterior_mean_coef2: np.ndarray = None
    # variance processor constants
    log_betas: np.ndarray = None                  # learned_range max_log
    fixed_large_log_variance: np.ndarray = None   # fixed_large

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def model_timesteps(self) -> np.ndarray:
        """Timestep values fed to the model for each respaced index.

        Mirrors _WrappedModel (gaussian_diffusion.py:484-489): map through
        timestep_map, then optionally rescale to the 0..1000 range.
        """
        ts = self.timestep_map.astype(np.float64)
        if self.rescale_timesteps:
            ts = ts * (1000.0 / self.original_num_steps)
        return ts.astype(np.float32)

    def device_constants(self) -> Dict[str, np.ndarray]:
        """fp32 copies of every per-step array, for indexing inside a scan."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray) and v.dtype == np.float64:
                out[f.name] = v.astype(np.float32)
        out["model_timesteps"] = self.model_timesteps()
        return out


def make_schedule(
    noise_schedule: str = "linear",
    steps: int = 1000,
    timestep_respacing: Union[str, int, Sequence[int], None] = None,
    rescale_timesteps: bool = False,
    betas: np.ndarray = None,
) -> DiffusionSchedule:
    """Build a (possibly respaced) schedule with every derived array.

    create_sampler semantics (gaussian_diffusion.py:38-62): betas come from
    the named schedule at the ORIGINAL step count, then SpacedDiffusion remaps
    them over the retained timesteps.
    """
    if betas is None:
        betas = get_named_beta_schedule(noise_schedule, steps)
    betas = np.asarray(betas, dtype=np.float64)
    original_num_steps = int(betas.shape[0])

    if timestep_respacing in (None, "", 0):
        timestep_respacing = [original_num_steps]
    use_timesteps = space_timesteps(original_num_steps, timestep_respacing)
    betas, timestep_map = respace_betas(betas, use_timesteps)

    assert betas.ndim == 1
    assert (0 < betas).all() and (betas <= 1).all(), "betas must be in (0..1]"

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # clipped because posterior variance is 0 at the chain start
    # (gaussian_diffusion.py:101-105)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )

    return DiffusionSchedule(
        betas=betas,
        timestep_map=timestep_map,
        rescale_timesteps=rescale_timesteps,
        original_num_steps=original_num_steps,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log_variance_clipped,
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        log_betas=np.log(betas),
        fixed_large_log_variance=np.log(np.append(posterior_variance[1], betas[1:])),
    )
