"""Rooflines of the H100: the least time a kernel could take, and the
dry-run's three-term record of a fleet step."""
from repro_torch.roofline.analysis import (BF16_TC_FLOPS, FP32_FLOPS, HBM_BW,
                                           IB_BW, LINK_BW, NVLINK_BW,
                                           PEAK_FLOPS, TF32_TC_FLOPS,
                                           Roofline, attained_fraction,
                                           count_active_params,
                                           kernel_roofline_time,
                                           model_flops_for_cell)

__all__ = ["BF16_TC_FLOPS", "FP32_FLOPS", "HBM_BW", "IB_BW", "LINK_BW",
           "NVLINK_BW", "PEAK_FLOPS", "TF32_TC_FLOPS", "Roofline",
           "attained_fraction", "count_active_params",
           "kernel_roofline_time", "model_flops_for_cell"]
