"""Frontier kernels: CUDA wrappers, plain versions, launch shapes."""
