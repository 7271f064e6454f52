"""Launcher of the windows-GEMM CUDA kernel (``csrc/windows_gemm.cu``).

Replaces ``repro/kernels/stencil_gemm/kernel.py::_gemm_kernel``.  The
caller (:func:`repro_torch.kernels.stencil_gemm.ops.windows_gemm`) checks
the arguments and allocates the output; this module only launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, library, stream_ptr


def table_bytes(L: int, K: int, itemsize: int) -> int:
    """Shared memory of one block: the B fragments of an (L, K) kernel
    matrix, one 8-byte word a lane for each k-step (8 positions in float32,
    16 in bfloat16) and each block of 8 outputs."""
    k_step = 8 if itemsize == 4 else 16
    return -(-K // k_step) * -(-L // 8) * 32 * 8


def windows_gemm_launch(km: torch.Tensor, windows: torch.Tensor,
                        y: torch.Tensor) -> None:
    """Launch on the current stream; returns without synchronising."""
    t, k, c = windows.shape
    lib = library()
    with torch.cuda.device(windows.device):
        status = lib.spider_windows_gemm(
            km.data_ptr(), windows.data_ptr(), y.data_ptr(), t, km.shape[0],
            k, c, DTYPE_CODES[windows.dtype], stream_ptr(windows.device))
    check(status, "spider_windows_gemm")
