"""Public wrapper of the windows-GEMM kernel.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain torch version only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import DTYPE_CODES, SMEM_OPT_IN
from repro_torch.kernels.common import region
from repro_torch.kernels.stencil_gemm.kernel import (table_bytes,
                                                     windows_gemm_launch)
from repro_torch.kernels.stencil_gemm.ref import windows_gemm_ref


def windows_gemm(km: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """km (L, K); windows (T, K, C) -> (T, L, C), float32 accumulation."""
    if km.dim() != 2 or windows.dim() != 3 or windows.shape[1] != km.shape[1]:
        raise ValueError(f"need km (L, K) and windows (T, K, C), got "
                         f"{tuple(km.shape)} and {tuple(windows.shape)}")
    if windows.dtype not in DTYPE_CODES or km.dtype != windows.dtype:
        raise TypeError(f"km and windows must share a dtype in "
                        f"{tuple(DTYPE_CODES)}, got "
                        f"{km.dtype} and {windows.dtype}")
    if km.device != windows.device:
        raise ValueError("km and windows lie on different devices")
    if not (km.is_contiguous() and windows.is_contiguous()):
        raise ValueError("km and windows must be contiguous")
    smem = table_bytes(*km.shape, windows.element_size())
    if smem > SMEM_OPT_IN:
        raise ValueError(f"kernel matrix {tuple(km.shape)} needs {smem} bytes "
                         f"of shared memory, over the {SMEM_OPT_IN} a block "
                         f"may take")
    if windows.device.type == "cpu":
        with region("windows_gemm"):
            return windows_gemm_ref(km, windows)
    if windows.device.type != "cuda":
        raise ValueError(f"no kernel for device {windows.device}")
    t, _, c = windows.shape
    y = torch.empty((t, km.shape[0], c), dtype=windows.dtype,
                    device=windows.device)
    if y.numel() == 0:
        return y
    with region("windows_gemm"):
        windows_gemm_launch(km, windows, y)
    windows_gemm.launches += 1
    return y


windows_gemm.launches = 0    # type: ignore[attr-defined]
