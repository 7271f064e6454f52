"""The verifier's settings.

The defaults equal what the repo's ``[tool.repro-vet]`` block sets for the
reference (hot-path modules ``serving``/``tuner``, radii 1-4,
``code-host-sync`` at warning), with the launch audit's budgets keyed by
the port's backends (``gemm``, ``sptc``, ``cuda_sptc``).  The baseline
ships inside this package (``baseline.json``).  The CLI's ``--root`` and
``--baseline`` set the two fields a run may move; tests set the others on
the dataclass directly.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

#: the port's baseline, shipped with the package
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

#: severity per rule id
DEFAULT_SEVERITY: Dict[str, str] = {
    # invariant analyzer
    "invariant-banded": "error",
    "invariant-involution": "error",
    "invariant-24": "error",
    "invariant-meta": "error",
    "invariant-gather-range": "error",
    "invariant-roundtrip": "error",
    "invariant-plan-stages": "error",
    "invariant-shared-pattern": "error",
    # launch audit, plain engines
    "lowering-dot-count": "error",
    "lowering-hot-gather": "error",
    "lowering-hot-overhead": "error",
    "lowering-sparse-parity": "error",
    "launch-per-call-rebuild": "error",
    "launch-output-mismatch": "error",
    # launch audit, the fused cuda_sptc kernel
    "pallas-fused-program": "error",
    "pallas-fused-gather": "error",
    "pallas-fused-overhead": "error",
    # launch audit on the card: device work no torch op explains
    "outside-device-ops": "error",
    # sharded halo-exchange analyzer
    "sharded-collective-budget": "error",
    "sharded-all-gather": "error",
    # code analyzer
    "code-jit-per-call": "error",
    "code-host-sync": "warning",
    "code-lock-discipline": "error",
    "code-locked-suffix": "error",
    "code-nondet-key": "error",
}

#: per-backend op budget outside the kernels, per 1-D application.  The
#: window gather is intrinsic; a scatter (index_put_/scatter, the
#: counterpart of a dynamic-update-slice) is runtime-indexed addressing
#: that SPIDER's §3.3 row-swap contract forbids.
DEFAULT_HOT_BUDGET: Dict[str, Dict[str, int]] = {
    "gemm": {"gather": 1, "scatter": 0},
    "sptc": {"gather": 1, "scatter": 0},
    # the fused kernel reads its own windows: at most 1 gather per
    # application may remain outside it, no scatter
    "cuda_sptc": {"gather": 1, "scatter": 0},
}


@dataclasses.dataclass
class VetConfig:
    baseline: str = str(DEFAULT_BASELINE)
    severity: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SEVERITY))
    hot_path_modules: List[str] = dataclasses.field(
        default_factory=lambda: ["serving", "tuner"])
    hot_path_functions: List[str] = dataclasses.field(
        default_factory=lambda: ["submit", "_run_batch", "_execute",
                                 "_worker", "map", "drain", "__call__",
                                 "tuned_apply", "tuned_apply_batched"])
    lowering_budgets: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: {b: dict(v)
                                 for b, v in DEFAULT_HOT_BUDGET.items()})
    lowering_backends: List[str] = dataclasses.field(
        default_factory=lambda: ["gemm", "sptc"])
    invariant_radii: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 3, 4])
    root: Path = dataclasses.field(default_factory=Path.cwd)

    def severity_of(self, rule: str, default: str = "error") -> str:
        return self.severity.get(rule, DEFAULT_SEVERITY.get(rule, default))

    def baseline_path(self) -> Path:
        p = Path(self.baseline)
        return p if p.is_absolute() else self.root / p

