from repro_torch.kernels.sptc_spmm.ops import (FusedOperand, RowsOperand,
                                               StarOperand, fused_operand,
                                               rows_operand, sptc_spmm,
                                               sptc_spmm_fused,
                                               sptc_spmm_rows2d,
                                               sptc_spmm_star2d,
                                               sptc_spmm_windows,
                                               star_operand)
from repro_torch.kernels.sptc_spmm.ref import (sptc_fused_ref,
                                               sptc_rows2d_ref, sptc_spmm_ref,
                                               sptc_spmm_windows_ref,
                                               sptc_star2d_ref)

__all__ = ["FusedOperand", "RowsOperand", "StarOperand", "fused_operand",
           "rows_operand", "star_operand", "sptc_spmm", "sptc_spmm_fused",
           "sptc_spmm_rows2d", "sptc_spmm_star2d", "sptc_spmm_windows",
           "sptc_fused_ref", "sptc_rows2d_ref", "sptc_star2d_ref",
           "sptc_spmm_ref", "sptc_spmm_windows_ref"]
