"""Public wrappers of the direct stencil kernel for 1-D and 2-D problems.

:func:`stencil_taps` turns a weight array into the kernel's tap buffers
once; :func:`stencil2d` / :func:`stencil1d` apply them.  On a CUDA tensor
the wrappers launch the kernel or raise; they take the plain torch version
only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.stencil_direct.kernel import stencil2d_launch
from repro_torch.kernels.stencil_direct.ref import stencil2d_ref


#: largest radius per axis the CUDA kernel is instantiated for (7 x 7 taps)
MAX_RADIUS = 3


@dataclasses.dataclass(frozen=True)
class Taps:
    """Taps of a (2rh+1, 2rw+1) weight array, for ``device``.

    ``host`` holds the non-zero ``(u, v, weight)`` triples (what the plain
    version sums); ``weights`` is the (2rh+1, 2rw+1) float32 array on the
    CPU that the kernel takes by value; ``star`` says every non-zero tap
    lies on the centre row or column, so the kernel skips the others.
    """

    host: Tuple[Tuple[int, int, float], ...]
    weights: torch.Tensor
    star: bool
    rh: int
    rw: int
    device: torch.device


def stencil_taps(weights: np.ndarray, device: Device = None) -> Taps:
    """Taps of a 2-D weight array (a 1-D array is one row), for ``device``
    (``None``: the card, raising without one)."""
    device = resolve_device(device)
    weights = np.asarray(weights)
    if weights.ndim == 1:
        weights = weights.reshape(1, -1)
    kh, kw = weights.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"weights must have odd extents, got {weights.shape}")
    rh, rw = (kh - 1) // 2, (kw - 1) // 2
    host = tuple((u, v, float(np.float32(weights[u, v])))
                 for u in range(kh) for v in range(kw) if weights[u, v] != 0)
    return Taps(host=host,
                weights=torch.tensor(weights, dtype=torch.float32),
                star=all(u == rh or v == rw for u, v, _ in host),
                rh=rh, rw=rw, device=device)


def stencil2d(taps: Taps, x: torch.Tensor) -> torch.Tensor:
    """x (H+2rh, W+2rw) or (B, H+2rh, W+2rw) -> (H, W) or (B, H, W).

    Float32 accumulation, output in ``x.dtype``.
    """
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be 2-D or batched 2-D, got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not in {tuple(DTYPE_CODES)}")
    if taps.device != x.device:
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
    if max(taps.rh, taps.rw) > MAX_RADIUS:
        raise ValueError(f"the direct kernel takes radii up to {MAX_RADIUS} "
                         f"per axis, got ({taps.rh}, {taps.rw})")
    xb = x if x.dim() == 3 else x[None]
    y = torch.empty((xb.shape[0], h, w), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or not taps.host:
        y.zero_()
    else:
        stencil2d_launch(xb, y, taps.weights, taps.star)
        stencil2d.launches += 1
    return y if x.dim() == 3 else y[0]


stencil2d.launches = 0    # type: ignore[attr-defined]


def stencil1d(taps: Taps, x: torch.Tensor) -> torch.Tensor:
    """1-D stencil as one row of the 2-D kernel: x (N+2r,) -> (N,)."""
    if x.dim() != 1 or taps.rh != 0:
        raise ValueError("stencil1d needs a 1-D input and one row of taps")
    return stencil2d(taps, x[None, :])[0]
