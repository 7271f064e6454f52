"""Kernel-level roofline of the H100: the least time a kernel could take."""
from repro_torch.roofline.analysis import (BF16_TC_FLOPS, FP32_FLOPS, HBM_BW,
                                           TF32_TC_FLOPS, attained_fraction,
                                           kernel_roofline_time)

__all__ = ["BF16_TC_FLOPS", "FP32_FLOPS", "HBM_BW", "TF32_TC_FLOPS",
           "attained_fraction", "kernel_roofline_time"]
