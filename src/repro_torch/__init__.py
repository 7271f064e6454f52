"""SPIDER on PyTorch and CUDA: the stencil -> 2:4-sparse GEMM transform,
its interpreter engine and hand-written Hopper kernels.

Imports torch and numpy only, never jax nor the JAX reference package.
"""
