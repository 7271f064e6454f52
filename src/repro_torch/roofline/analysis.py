"""Two-term kernel roofline on one NVIDIA H100 SXM.

    compute = operations / peak rate for their type
    memory  = bytes moved / device memory rate

Constants from NVIDIA's H100 Tensor Core GPU datasheet (SXM5 part, dense
rates without sparsity, at the 700 W power limit).  A card set to a lower
power limit runs below them under load, so a share of the roofline is
stated beside the card's limit.  The dry-run's HLO and collective terms of
the reference (``collective_bytes``, ``from_compiled``,
``model_flops_for_cell``) are not here: they belong to the launch dry-run.
"""
from __future__ import annotations

HBM_BW = 3.35e12             # bytes/s, HBM3
FP32_FLOPS = 67e12           # float32 outside the tensor cores
TF32_TC_FLOPS = 494.7e12     # dense TF32 on the tensor cores
BF16_TC_FLOPS = 989.4e12     # dense bf16 on the tensor cores


def kernel_roofline_time(flops: float, hbm_bytes: float, *,
                         peak_flops: float = FP32_FLOPS,
                         chips: int = 1) -> float:
    """max(compute, memory) seconds for one kernel.

    ``flops`` are the operations the kernel must do on its inputs, at
    ``peak_flops`` (the rate of the unit and type that executes them);
    ``hbm_bytes`` count each input read once and each output written once.
    """
    t_compute = flops / (chips * peak_flops)
    t_memory = hbm_bytes / (chips * HBM_BW)
    return max(t_compute, t_memory)


def attained_fraction(measured_s: float, flops: float, hbm_bytes: float, *,
                      peak_flops: float = FP32_FLOPS,
                      chips: int = 1) -> float:
    """roofline_time / measured_time — 1.0 means running at the roofline."""
    if measured_s <= 0:
        return 0.0
    return kernel_roofline_time(flops, hbm_bytes, peak_flops=peak_flops,
                                chips=chips) / measured_s
