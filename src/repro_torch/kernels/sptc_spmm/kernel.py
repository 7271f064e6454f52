"""Launcher of the fused SpTC CUDA kernel (``csrc/sptc_fused.cu``).

Replaces ``repro/kernels/sptc_spmm/kernel.py::_fused_kernel``.  The caller
(:func:`repro_torch.kernels.sptc_spmm.ops.sptc_spmm_fused`) checks the
arguments and allocates the output; this module only launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, library, stream_ptr


def sptc_fused_launch(x2d: torch.Tensor, y: torch.Tensor,
                      values: torch.Tensor, meta_words: torch.Tensor, *,
                      n_out: int, L: int, star_fast: bool,
                      bf16_compute: bool) -> None:
    """Launch on the current stream; returns without synchronising."""
    lib = library()
    with torch.cuda.device(x2d.device):
        status = lib.spider_sptc_fused(
            x2d.data_ptr(), y.data_ptr(), values.data_ptr(),
            meta_words.data_ptr(), x2d.shape[0], x2d.shape[1], x2d.stride(0),
            n_out, L, values.shape[1], meta_words.shape[1], int(star_fast),
            int(bf16_compute), DTYPE_CODES[x2d.dtype],
            stream_ptr(x2d.device))
    check(status, "spider_sptc_fused")
