"""Peaks of the card and the least work of a stencil application.

Peaks from NVIDIA's H100 SXM data sheet (dense, at the 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
A stencil's least work counts each input point (halo included) read once,
each output point written once and ``2 * taps`` FLOP per output point,
whatever kernel implements it; the least time is the larger of the two
bounds.  A share of it over measured kernel time cannot pass 100 % unless
the kernels did less than the stencil needs.
"""
from __future__ import annotations

from typing import Optional

HBM_BW = 3.35e12            # bytes/s
FP32_FLOPS = 67e12          # FLOP/s


def stencil_least_seconds(in_points: int, out_points: int, taps: int,
                          itemsize: int) -> float:
    """Least time of one application: max(bytes / HBM_BW, FLOP / peak)."""
    moved = (in_points + out_points) * itemsize
    flops = 2 * taps * out_points
    return max(moved / HBM_BW, flops / FP32_FLOPS)


def share_pct(least_s: float, kernel_s: float) -> Optional[float]:
    """``least_s`` as a percentage of ``kernel_s``; None without kernel time."""
    if kernel_s <= 0:
        return None
    return 100.0 * least_s / kernel_s
