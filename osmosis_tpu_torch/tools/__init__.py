"""Benchmarks of the port on a CUDA card."""
