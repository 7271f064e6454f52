"""Launchers of the two SpTC CUDA kernels.

``csrc/sptc_fused.cu`` replaces ``repro/kernels/sptc_spmm/kernel.py::
_fused_kernel``; ``csrc/sptc_spmm.cu`` replaces the v1 ``_sptc_kernel``.
The callers (:mod:`repro_torch.kernels.sptc_spmm.ops`) check the arguments
and allocate the outputs; this module only launches.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, library, stream_ptr

if TYPE_CHECKING:
    from repro_torch.kernels.sptc_spmm.fragments import Fragments


def sptc_fused_launch(x2d: torch.Tensor, y: torch.Tensor,
                      frags: "Fragments", *, n_out: int, L: int,
                      tf32: bool) -> None:
    """Launch on the current stream; returns without synchronising.

    ``tf32``: float32 storage through ``mma.sp...tf32`` (3xTF32) with
    ``frags`` the operand's TF32 tables; otherwise bfloat16 storage or
    compute through ``mma.sp...bf16`` with its BF16 tables.
    """
    lib = library()
    with torch.cuda.device(x2d.device):
        status = lib.spider_sptc_fused(
            x2d.data_ptr(), y.data_ptr(), frags.a.data_ptr(),
            frags.e.data_ptr(), x2d.shape[0], x2d.shape[1], x2d.stride(0),
            n_out, L, frags.ksteps, 0 if tf32 else 1,
            DTYPE_CODES[x2d.dtype], stream_ptr(x2d.device))
    check(status, "spider_sptc_fused")


def sptc_spmm_launch(values: torch.Tensor, meta: torch.Tensor,
                     windows: torch.Tensor, y: torch.Tensor) -> None:
    """v1 SpMM over (T, K, N) windows into (T, M, N); launch on the current
    stream, returns without synchronising."""
    lib = library()
    t, _, n = windows.shape
    m, kh = values.shape
    with torch.cuda.device(windows.device):
        status = lib.spider_sptc_spmm(
            values.data_ptr(), meta.data_ptr(), windows.data_ptr(),
            y.data_ptr(), m, kh, n, windows.stride(1), windows.stride(0), t,
            DTYPE_CODES[windows.dtype], stream_ptr(windows.device))
    check(status, "spider_sptc_spmm")
