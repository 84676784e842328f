"""The system under test, built from a preset dict the way the port's
``pipelines.restore.run_restoration`` builds it from its YAML: the schedule,
the sampler and guidance configurations and the operator, with TF32 off and
cuDNN's algorithms chosen by the port's own rule for a run without
``chain_checkpoint``. The chain entry is the one ``run_restoration`` calls:
``guided_sample_loop`` at batch 1, ``make_batched_segment_runner`` for a
fleet, one segment (``ts=``) per call. The model it calls is the family's
(``families/<family>.py``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from osmosis_tpu_torch.diffusion.guided import GuidanceConfig, guided_sample_loop
from osmosis_tpu_torch.diffusion.sampler import SamplerConfig
from osmosis_tpu_torch.diffusion.schedules import make_schedule
from osmosis_tpu_torch.guidance.operators import get_operator
from osmosis_tpu_torch.parallel.runner import make_batched_segment_runner
from osmosis_tpu_torch.pipelines import restore


def settings(dtype: torch.dtype, device: torch.device) -> SimpleNamespace:
    """The arithmetic a run with the torso dtype ``dtype`` takes on
    ``device``: TF32 (off on a card, as ``run_restoration`` sets it) and
    cuDNN's algorithms."""
    deterministic = restore.cudnn_deterministic(device, dtype, chain_checkpoint=False)
    return SimpleNamespace(dtype=dtype, deterministic=deterministic,
                           algorithms=restore.algorithms_str(device, deterministic),
                           precision=restore.precision_str(device, dtype))


cudnn_algorithms = restore.cudnn_algorithms


def set_tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def build_chain(preset: dict, model_fn, lanes: int):
    """``segment(x, y, chain_seed, phi, opt, ts, buf) -> GuidedResult``: one
    call of the program's chain entry over the timesteps ``ts``, from the
    state the previous segment handed on."""
    d, m = preset["diffusion"], preset["measurement"]
    schedule = make_schedule(noise_schedule=d["noise_schedule"], steps=d["steps"],
                             timestep_respacing=d.get("timestep_respacing", ""),
                             rescale_timesteps=d.get("rescale_timesteps", False))
    scfg = SamplerConfig(sampler=d["sampler"], model_mean_type=d["model_mean_type"],
                         model_var_type=d["model_var_type"],
                         dynamic_threshold=d.get("dynamic_threshold", False),
                         clip_denoised=d.get("clip_denoised", False))
    op_kwargs = {k: v for k, v in m["operator"].items() if k != "name"}
    operator = get_operator(m["operator"]["name"], batch_size=1, **op_kwargs)
    sp = preset["sample_pattern"]
    gcfg = GuidanceConfig.from_config(preset["conditioning"]["method"],
                                      preset["conditioning"]["params"], sp,
                                      preset.get("aux_loss"), noiser_name=m["noise"]["name"])
    record_every = preset["record_every"] if preset.get("record_process") else None
    if lanes > 1:
        run = make_batched_segment_runner(model_fn, schedule, operator, gcfg, scfg, sp,
                                          record_every)

        def segment(x, y, seed, phi, opt, ts, buf):
            return run(x, y, seed, phi, opt, None, ts=ts, buf0s=buf)
    else:
        def segment(x, y, seed, phi, opt, ts, buf):
            return guided_sample_loop(model_fn, schedule, x, y, operator, gcfg, scfg,
                                      sample_pattern=sp, record_every=record_every,
                                      phi_init=phi, opt_state_init=opt, seed=seed, ts=ts,
                                      x0_buf_init=buf)
    return segment


def cold_phi(preset: dict, lanes: int, device):
    """None for a fleet (its runner starts each lane cold), else the
    operator's cold phi as ``run_restoration`` passes it."""
    if lanes > 1:
        return None
    m = preset["measurement"]["operator"]
    op = get_operator(m["name"], batch_size=1, **{k: v for k, v in m.items() if k != "name"})
    return {k: torch.as_tensor(v, device=device) for k, v in op.phi_init().items()}
