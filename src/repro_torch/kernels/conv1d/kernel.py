"""Launcher of the causal conv1d CUDA kernel (``csrc/conv1d_causal.cu``).

Replaces ``repro/kernels/conv1d/kernel.py::_conv_kernel``.  The caller
(:func:`repro_torch.kernels.conv1d.ops.conv1d_causal`) checks the arguments
and allocates the output; this module only launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, library, stream_ptr

#: widest filter the kernel keeps in registers (one template per width)
MAX_TAPS = 8


def conv1d_causal_launch(x: torch.Tensor, w: torch.Tensor,
                         y: torch.Tensor) -> None:
    """Launch on the current stream; returns without synchronising."""
    lib = library()
    b, t, d = x.shape
    with torch.cuda.device(x.device):
        status = lib.spider_conv1d_causal(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, d, x.stride(0),
            x.stride(1), w.shape[0], DTYPE_CODES[x.dtype],
            stream_ptr(x.device))
    check(status, "spider_conv1d_causal")
