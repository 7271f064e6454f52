"""Plain torch version of the direct stencil kernel (``csrc/stencil_direct.cu``)."""
from __future__ import annotations

import torch


def stencil2d_ref(taps, x: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """Shifted multiply-adds over ``taps`` = ((u, v, w), ...), float32 sum.

    x (..., H+2rh, W+2rw) -> (..., H, W) in ``x.dtype``.
    """
    h = x.shape[-2] - 2 * rh
    w = x.shape[-1] - 2 * rw
    acc = torch.zeros(x.shape[:-2] + (h, w), dtype=torch.float32,
                      device=x.device)
    for u, v, wt in taps:
        acc += wt * x[..., u:u + h, v:v + w].float()
    return acc.to(x.dtype)
