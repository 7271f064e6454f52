"""SPIDER on PyTorch and CUDA: the stencil -> 2:4-sparse GEMM transform,
its interpreter engine, hand-written Hopper kernels, the tuner that picks
among them and the serving drivers.

Imports torch and numpy only, never jax nor the JAX reference package.
"""
