"""Hand-written Hopper kernels (K1/K2 in CUDA C++, K3/K4 in Triton), each
beside its plain PyTorch version."""
