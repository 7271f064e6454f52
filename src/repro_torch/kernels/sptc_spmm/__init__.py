from repro_torch.kernels.sptc_spmm.ops import (FusedOperand, fused_operand,
                                               sptc_spmm_fused)
from repro_torch.kernels.sptc_spmm.ref import sptc_fused_ref

__all__ = ["FusedOperand", "fused_operand", "sptc_spmm_fused",
           "sptc_fused_ref"]
