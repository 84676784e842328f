"""osmosis_tpu_torch — the Osmosis RGBD guided-diffusion restoration pipeline
on PyTorch and CUDA for an NVIDIA H100 (Hopper).

A port of the JAX package ``osmosis_tpu``, which stays beside it as the
reference. The module tree mirrors ``osmosis_tpu``; the port imports nothing
of it. The hand-written kernels live in :mod:`osmosis_tpu_torch.ops`. Entry
points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

# the top-level API, imported at first use: name -> the module that defines it
_LAZY = {
    "run_restoration": "pipelines.restore",
    "run_prior_sampling": "pipelines.prior",
    "UNetModel": "models.unet",
    "UNetConfig": "models.unet",
    "unet_config_from_yaml": "models.unet",
    "make_schedule": "diffusion.schedules",
    "SamplerConfig": "diffusion.sampler",
    "sample_loop": "diffusion.sampler",
    "GuidanceConfig": "diffusion.guided",
    "guided_sample_loop": "diffusion.guided",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
