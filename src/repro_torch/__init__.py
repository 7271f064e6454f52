"""SPIDER on PyTorch and CUDA: the stencil -> 2:4-sparse GEMM transform,
its interpreter engine, hand-written Hopper kernels, the tuner that picks
among them, the halo-exchange engine for partitioned grids, the serving
drivers and the LM sidecar's models and training.

Imports torch and numpy only, never JAX nor the JAX reference package.
"""
