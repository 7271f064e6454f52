"""Launcher of the direct stencil CUDA kernel (``csrc/stencil_direct.cu``).

Replaces ``repro/kernels/stencil_direct/kernel.py::_stencil_kernel``.  The
caller (:func:`repro_torch.kernels.stencil_direct.ops.stencil2d`) checks
the arguments and allocates the output; this module only launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, library, stream_ptr


def stencil2d_launch(x: torch.Tensor, y: torch.Tensor, tap_u: torch.Tensor,
                     tap_v: torch.Tensor, tap_w: torch.Tensor) -> None:
    """x (B, H+2rh, W+2rw), y (B, H, W); launches without synchronising."""
    b, h, w = y.shape
    lib = library()
    with torch.cuda.device(x.device):
        status = lib.spider_stencil2d(
            x.data_ptr(), y.data_ptr(), tap_u.data_ptr(), tap_v.data_ptr(),
            tap_w.data_ptr(), tap_w.shape[0], b, h, w, x.stride(0),
            x.stride(1), DTYPE_CODES[x.dtype], stream_ptr(x.device))
    check(status, "spider_stencil2d")
