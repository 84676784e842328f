"""Hand-written Hopper kernels (K1-K4, CUDA C++ in ``csrc/``), each beside
its plain PyTorch version."""
