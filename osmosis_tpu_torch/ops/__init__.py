"""Hand-written Hopper kernels (K1-K5, CUDA C++ in ``csrc/``), each beside
its plain PyTorch version."""
