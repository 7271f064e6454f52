"""The profiler region every kernel wrapper opens around its kernel.

Each wrapper runs its plain version (a CPU tensor) or launches its kernel
(a CUDA tensor) inside one ``torch.profiler.record_function`` region named
after the wrapper.  On the card the region holds the launch alone: the
wrapper's own torch ops (an output buffer, a dtype or contiguity copy) run
outside it.  ``repro_torch.vet.lowering`` counts those regions as the
programs of a call: whatever runs outside them is the work the engine does
around its kernels.
"""
from __future__ import annotations

import contextlib
from typing import ContextManager

import torch

#: region name -> the CUDA kernel (``csrc/``) its wrapper launches inside it
KERNEL_REGIONS = {
    "sptc_spmm_fused": "sptc_mma_kernel",
    "sptc_spmm_windows": "sptc_spmm_kernel",
    "windows_gemm": "windows_gemm_kernel",
    "stencil2d": "stencil2d_kernel",
    "conv1d_causal": "conv1d_causal_kernel",
}


def region(name: str) -> ContextManager:
    """The profiler region of kernel wrapper ``name``.

    With no profiler active this costs one flag check, where a bare
    ``record_function`` would enter the dispatcher on every call.
    """
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
