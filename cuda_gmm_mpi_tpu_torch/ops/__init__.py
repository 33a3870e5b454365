"""Numerics of the port: the torch-ops backend and the CUDA kernels."""
