from repro_torch.kernels.stencil_gemm.ops import windows_gemm
from repro_torch.kernels.stencil_gemm.ref import windows_gemm_ref

__all__ = ["windows_gemm", "windows_gemm_ref"]
