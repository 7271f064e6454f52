"""Launcher of the direct stencil CUDA kernel (``csrc/stencil_direct.cu``).

Replaces ``repro/kernels/stencil_direct/kernel.py::_stencil_kernel``.  The
caller (:func:`repro_torch.kernels.stencil_direct.ops.stencil2d`) checks
the arguments and allocates the output; this module only launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, library, stream_ptr


def stencil2d_launch(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
                     star: bool) -> None:
    """x (B, H+2rh, W+2rw), y (B, H, W), each with a unit column stride;
    ``weights`` the (2rh+1, 2rw+1) float32 taps on the CPU, passed by
    value.  Launches without synchronising."""
    b, h, w = y.shape
    kh, kw = weights.shape
    lib = library()
    with torch.cuda.device(x.device):
        status = lib.spider_stencil2d(
            x.data_ptr(), y.data_ptr(), weights.contiguous().data_ptr(),
            (kh - 1) // 2, (kw - 1) // 2, int(star), b, h, w, x.stride(0),
            x.stride(1), y.stride(0), y.stride(1), DTYPE_CODES[x.dtype],
            stream_ptr(x.device))
    check(status, "spider_stencil2d")
