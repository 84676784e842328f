"""osmosis_tpu_torch — the Osmosis RGBD guided-diffusion restoration pipeline
on PyTorch and CUDA for an NVIDIA H100 (Hopper).

A port of the JAX package ``osmosis_tpu``, which stays beside it as the
reference. The module tree mirrors ``osmosis_tpu``; the port imports nothing
of it. The hand-written kernels live in :mod:`osmosis_tpu_torch.ops`. Entry
points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
