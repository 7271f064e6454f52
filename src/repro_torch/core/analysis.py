"""Analytic cost models — paper §2.3 (baselines) and §3.2.3 (SPTCStencil).

All functions return **per-output-point** costs for a Box-2D stencil of
radius ``r`` over an A×B grid updated in c×c tiles, reproducing Table 1
(r=3, c=8, TCStencil L=16):

                 MACs    input-acc   param-acc
  lower bound    49      3.06        0.77
  TCStencil      286.72  17.92       17.92
  ConvStencil    104     13          13
  LoRAStencil    144     4           12
  SPTCStencil    56      14          7

Paper erratum (documented, table-consistent version implemented): §3.2.3
prints SPTCStencil_C with a factor ``256·(r+1)`` = ``128·(2r+2)``; Table 1's
56 MACs/point corresponds to ``128·(2r+1)`` — i.e. one SpMM per kernel *row*
(2r+1 of them), each M=N=8⌈c/8⌉, K=4⌈(2r+c)/4⌉, with SpTC executing K/2.
We implement the table-consistent count.

The port's own row, ``cuda_direct``: the shared-memory-tiled direct kernel
(``kernels/csrc/stencil_direct.cu``) does exactly the (2r+1)² lower-bound
MACs per point on the CUDA cores, reading each input of a tile with its
halo once.  A banded matrix multiplied as dense GEMM wastes
``(band + M - 1)/band >= 2x`` MACs for any tiling scheme; SpTC approaches
the lower bound in hardware at 2:4.

Hardware-free: a copy of the reference's ``core/analysis.py`` rows.
"""
from __future__ import annotations

import dataclasses
import math


def _ceil(a: float, b: float) -> int:
    return int(math.ceil(a / b))


@dataclasses.dataclass(frozen=True)
class Cost:
    macs: float           # multiply-adds per output point
    input_access: float   # input elements loaded per output point
    param_access: float   # stencil parameters loaded per output point

    def as_tuple(self) -> tuple:
        return (self.macs, self.input_access, self.param_access)


def lower_bound(r: int, c: int = 8) -> Cost:
    return Cost(
        macs=(2 * r + 1) ** 2,
        input_access=(c + 2 * r) ** 2 / c ** 2,
        param_access=(2 * r + 1) ** 2 / c ** 2,
    )


def tcstencil(r: int, L: int = 16) -> Cost:
    pts = (L - 2 * r) ** 2
    macs = L ** 3 * (2 * r + 1) / pts
    acc = L ** 2 * (2 * r + 1) / pts
    return Cost(macs=macs, input_access=acc, param_access=acc)


def convstencil(r: int, c: int = 8) -> Cost:
    # Updates 8ceil(c/8) x (2r+2) points via two GEMMs of
    # M=8ceil(c/8), N=8ceil((2r+2)/8), K=4ceil((2r+1)^2/4)   (§2.3.1)
    # Per-point normalization: ceil(A/(2c(r+1)))/A -> 1/(2c(r+1)) asymptotically
    per_b_rows = 1.0 / (2 * c * (r + 1))
    macs = 512 * per_b_rows * _ceil(c, 8) * _ceil(r + 1, 4) * _ceil((2 * r + 1) ** 2, 4)
    inp = 64 * _ceil((2 * r + 1) ** 2, 4) * per_b_rows * _ceil(c, 8)
    par = inp * _ceil(r + 1, 4)
    return Cost(macs=macs, input_access=inp, param_access=par)


def lorastencil(r: int, c: int = 8) -> Cost:
    macs = (256 * r / c ** 2) * _ceil(c, 8) * _ceil(2 * r + c, 4) * (
        _ceil(2 * r + c, 8) + _ceil(c, 8))
    inp = (32 / c ** 2) * _ceil(2 * r + c, 4) * _ceil(2 * r + c, 8)
    par = 4 * r / _ceil(r, 4)
    return Cost(macs=macs, input_access=inp, param_access=par)


def sptcstencil(r: int, c: int = 8) -> Cost:
    """Table-1-consistent SPTCStencil cost (see module docstring erratum)."""
    m = 8 * _ceil(c, 8)
    n = 8 * _ceil(c, 8)
    k = 4 * _ceil(2 * r + c, 4)
    rows = 2 * r + 1
    macs = rows * m * n * (k // 2) / c ** 2
    inp = (32 / c ** 2) * rows * _ceil(c, 8) * _ceil(2 * r + c, 4)
    par = (16 / c ** 2) * rows * _ceil(c, 8) * _ceil(2 * r + c, 4)
    return Cost(macs=macs, input_access=inp, param_access=par)


def cuda_direct(r: int, c: int = 8) -> Cost:
    """The port's direct kernel: lower-bound MACs, each tile input read once."""
    lb = lower_bound(r, c)
    return Cost(macs=lb.macs, input_access=lb.input_access,
                param_access=(2 * r + 1) ** 2 / c ** 2)


METHODS = {
    "lower_bound": lower_bound,
    "tcstencil": lambda r, c=8: tcstencil(r),
    "convstencil": convstencil,
    "lorastencil": lorastencil,
    "sptcstencil": sptcstencil,
    "cuda_direct": cuda_direct,
}


def table1(r: int = 3, c: int = 8) -> dict:
    """Reproduce Table 1 (+ the port's direct-kernel row)."""
    return {name: fn(r, c) if name != "tcstencil" else tcstencil(r)
            for name, fn in METHODS.items()}
