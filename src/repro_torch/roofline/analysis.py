"""Rooflines on NVIDIA H100 SXM: a kernel's two terms, a fleet step's three.

Kernel (one card, no collectives):

    compute = operations / peak rate for their type
    memory  = bytes moved / device memory rate

Fleet step (the dry-run, ``launch/dryrun.py``; per device, every device
alike):

    compute    = FLOPs      / PEAK_FLOPS
    memory     = dot bytes  / HBM_BW
    collective = sum over mesh axes of that axis's bytes / its link rate

Constants from NVIDIA's H100 Tensor Core GPU datasheet (SXM5 part, dense
rates without sparsity, at the 700 W power limit).  A card set to a lower
power limit runs below them under load, so a share of the roofline is
stated beside the card's limit.  The links: NVLink 4 at 450 GB/s per
direction per card inside a node of eight ('model'), and one 400 Gb/s
InfiniBand NDR port per card, 50 GB/s, across nodes ('data', 'pod').
The reference's ``collective_bytes`` and ``from_compiled`` read XLA's HLO
text and are not ported: the dry-run counts the collectives DTensor issues.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

HBM_BW = 3.35e12             # bytes/s, HBM3
FP32_FLOPS = 67e12           # float32 outside the tensor cores
TF32_TC_FLOPS = 494.7e12     # dense TF32 on the tensor cores
BF16_TC_FLOPS = 989.4e12     # dense bf16 on the tensor cores
PEAK_FLOPS = BF16_TC_FLOPS   # a fleet step's compute rate per card
NVLINK_BW = 450e9            # bytes/s per direction per card, in a node
IB_BW = 50e9                 # bytes/s per card: 400 Gb/s InfiniBand NDR
#: the link rate of each mesh axis (an axis not listed crosses nodes)
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}


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


# ---------------------------------------------------------------------------
# Fleet-step roofline (the dry-run's record)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    cell: str
    mesh: str
    chips: int
    # global quantities (all cards)
    flops: float                 # traced FLOPs
    hbm_bytes: float             # matmul operand and result bytes
    coll_by_op: Dict[str, int]   # per device, by op
    # analytic
    model_flops: float           # 6 * N(_active) * D
    # memory footprint
    per_device_bytes: int
    coll_by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)
    raw_flops: float = 0.0       # per device
    top_collectives: tuple = ()

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        """Each axis's per-device bytes over its link's rate, summed."""
        return sum(b / LINK_BW.get(a, IB_BW)
                   for a, b in self.coll_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / traced FLOPs — how much of the compute is useful."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time
        return (self.model_flops / t) / (self.chips * PEAK_FLOPS) if t else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_gflops": self.flops / 1e9,
            "model_gflops": self.model_flops / 1e9,
            "useful_frac": self.useful_flops_frac,
            "mfu_at_roofline": self.mfu,
            "per_device_gb": self.per_device_bytes / 1e9,
            "coll_by_op_mb": {k: v / 1e6 for k, v in self.coll_by_op.items()
                              if v},
            "coll_by_axis_mb": {k: v / 1e6
                                for k, v in self.coll_by_axis.items() if v},
            "raw_gflops_perdev": self.raw_flops / 1e9,
            "top_collectives": list(self.top_collectives[:6]),
        }


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6ND) helpers
# ---------------------------------------------------------------------------

def _paths(tree, prefix: str = ""):
    """(``/``-path, leaf) of every leaf; list items are their index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def count_active_params(cfg, params) -> Tuple[int, int]:
    """(total, active) parameter counts of a parameter tree (e.g. on the
    meta device), as the reference counts its stacked tree
    (``analysis.py:228-255``).

    Active discounts MoE experts to top_k/n_experts of expert weights and
    excludes the untied input embedding (a gather, not a matmul; the
    unembed projection is counted)."""
    total = active = 0
    for keys, leaf in _paths(params):
        n = int(leaf.numel())
        total += n
        if keys.endswith("embed") and "pos" not in keys and \
                not cfg.tie_embeddings:
            continue
        if "/moe/w" in keys and cfg.n_experts:
            n = n * cfg.top_k // cfg.n_experts
        active += n
    return total, active


def model_flops_for_cell(cfg, cell, params) -> float:
    """6 * N_active * D for train; 2 * N_active * D for inference cells."""
    _, active = count_active_params(cfg, params)
    if cell.kind == "train":
        return 6.0 * active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * active * cell.global_batch * cell.seq_len
    return 2.0 * active * cell.global_batch        # one decode token
