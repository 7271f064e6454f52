"""Public wrappers of the direct stencil kernel for 1-D and 2-D problems.

:func:`stencil_taps` turns a weight array into the kernel's tap buffers
once; :func:`stencil2d` / :func:`stencil1d` apply them.  On a CUDA tensor
the wrappers launch the kernel or raise; they take the plain torch version
only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES, SMEM_LIMIT
from repro_torch.kernels.stencil_direct.kernel import stencil2d_launch
from repro_torch.kernels.stencil_direct.ref import stencil2d_ref


@dataclasses.dataclass(frozen=True)
class Taps:
    """Non-zero taps of a (2rh+1, 2rw+1) weight array.

    ``host`` holds the ``(u, v, weight)`` triples (star zeros pruned);
    ``u``/``v`` (int32) and ``w`` (float32) are the same on the device.
    """

    host: Tuple[Tuple[int, int, float], ...]
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    rh: int
    rw: int


def stencil_taps(weights: np.ndarray,
                 device: Union[str, torch.device] = "cpu") -> Taps:
    """Tap buffers of a 2-D weight array (a 1-D array is one row)."""
    weights = np.asarray(weights)
    if weights.ndim == 1:
        weights = weights.reshape(1, -1)
    kh, kw = weights.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"weights must have odd extents, got {weights.shape}")
    host = tuple((u, v, float(np.float32(weights[u, v])))
                 for u in range(kh) for v in range(kw) if weights[u, v] != 0)
    if len(host) * 12 > SMEM_LIMIT:
        raise ValueError(f"{len(host)} taps exceed {SMEM_LIMIT} bytes of "
                         "shared memory")
    cols = list(zip(*host)) if host else [(), (), ()]
    return Taps(host=host,
                u=torch.tensor(cols[0], dtype=torch.int32, device=device),
                v=torch.tensor(cols[1], dtype=torch.int32, device=device),
                w=torch.tensor(cols[2], dtype=torch.float32, device=device),
                rh=(kh - 1) // 2, rw=(kw - 1) // 2)


def stencil2d(taps: Taps, x: torch.Tensor) -> torch.Tensor:
    """x (H+2rh, W+2rw) or (B, H+2rh, W+2rw) -> (H, W) or (B, H, W).

    Float32 accumulation, output in ``x.dtype``.
    """
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be 2-D or batched 2-D, got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not in {tuple(DTYPE_CODES)}")
    if taps.w.device != x.device:
        raise ValueError("taps and x lie on different devices")
    h = x.shape[-2] - 2 * taps.rh
    w = x.shape[-1] - 2 * taps.rw
    if h < 0 or w < 0:
        raise ValueError(f"input {tuple(x.shape)} smaller than the halo")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError("x needs a unit column stride")
    if x.device.type == "cpu":
        return stencil2d_ref(taps.host, x, taps.rh, taps.rw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    xb = x if x.dim() == 3 else x[None]
    y = torch.empty((xb.shape[0], h, w), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or not taps.host:
        y.zero_()
    else:
        stencil2d_launch(xb, y, taps.u, taps.v, taps.w)
        stencil2d.launches += 1
    return y if x.dim() == 3 else y[0]


stencil2d.launches = 0    # type: ignore[attr-defined]


def stencil1d(taps: Taps, x: torch.Tensor) -> torch.Tensor:
    """1-D stencil as one row of the 2-D kernel: x (N+2r,) -> (N,)."""
    if x.dim() != 1 or taps.rh != 0:
        raise ValueError("stencil1d needs a 1-D input and one row of taps")
    return stencil2d(taps, x[None, :])[0]
