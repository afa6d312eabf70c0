"""Kernel modules of the ground-state path and the batched logdet helpers.

Each kernel module holds a plain PyTorch version (CPU tensors) beside the
wrapper of its CUDA kernel (CUDA tensors); ``_build`` compiles and binds the
kernels and keeps their launch counts.
"""
