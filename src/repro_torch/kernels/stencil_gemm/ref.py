"""Plain torch version of the windows-GEMM kernel (``csrc/windows_gemm.cu``)."""
from __future__ import annotations

import torch


def windows_gemm_ref(km: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """km (L, K); windows (T, K, C) -> (T, L, C), float32 accumulation."""
    return torch.einsum("lk,tkc->tlc", km.to(windows.dtype).float(),
                        windows.float()).to(windows.dtype)
