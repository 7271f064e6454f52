"""Simulated Sparse Tensor Core semantics (plain torch reference).

``mma.sp`` computes, per output row i of the LHS:

    y[i, n] = sum_s sum_t  values[i, 2s+t] * X[4s + meta[i, 2s+t], n]

i.e. for every 4-wide segment of the reduction dim it reads only the 2 rows of
the RHS selected by the 2-bit metadata.  This module is the executable
semantics the CUDA kernel and the transformation pipeline are checked against.
"""
from __future__ import annotations

import numpy as np
import torch


def segment_gather(meta: torch.Tensor, half: int) -> torch.Tensor:
    """(M, K/2) RHS row of every compressed slot: 4 * (j // 2) + meta."""
    seg = (torch.arange(half, device=meta.device) // 2) * 4
    return seg[None, :] + meta.to(torch.int64)            # (M, K/2)


def sptc_matmul(values: torch.Tensor, meta: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Compressed 2:4 SpMM: (M, K/2) x metadata x (K, N) -> (M, N).

    values: (M, K/2) float; meta: (M, K/2) int in [0,4); x: (K, N).
    Accumulates in float32 and returns ``x.dtype``.
    """
    m, half = values.shape
    k = x.shape[0]
    if half * 2 != k:
        raise ValueError(f"values width {half} != K/2 = {k//2}")
    xg = x[segment_gather(meta, half)]                   # (M, K/2, N)
    return torch.einsum("mk,mkn->mn", values.to(x.dtype).float(),
                        xg.float()).to(x.dtype)


def sptc_matmul_dense_equiv(values: torch.Tensor, meta: torch.Tensor,
                            k: int) -> torch.Tensor:
    """Decompress (values, meta) to the dense (M, K) permuted matrix."""
    m, half = values.shape
    out = torch.zeros((m, k), dtype=values.dtype, device=values.device)
    return out.scatter_add_(1, segment_gather(meta, half), values)


def swap_rows(x: torch.Tensor, perm) -> torch.Tensor:
    """Zero-cost row swap (paper §3.3) — reference form.

    Column-permuting the LHS by ``perm`` requires row-permuting the RHS by the
    same involution for mathematical equivalence.  The CUDA kernel folds this
    indexing into its load addresses; here it is explicit.
    """
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.int64, device=x.device)
    return x[idx]
