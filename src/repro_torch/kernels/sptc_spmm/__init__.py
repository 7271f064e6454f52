from repro_torch.kernels.sptc_spmm.ops import (FusedOperand, fused_operand,
                                               sptc_spmm, sptc_spmm_fused,
                                               sptc_spmm_windows)
from repro_torch.kernels.sptc_spmm.ref import (sptc_fused_ref, sptc_spmm_ref,
                                               sptc_spmm_windows_ref)

__all__ = ["FusedOperand", "fused_operand", "sptc_spmm", "sptc_spmm_fused",
           "sptc_spmm_windows", "sptc_fused_ref", "sptc_spmm_ref",
           "sptc_spmm_windows_ref"]
