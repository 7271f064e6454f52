"""``[tool.repro-torch-vet]`` configuration (pyproject.toml).

Everything has a working default: a bare ``python -m repro_torch.vet`` on
a checkout needs no config at all.  The block has the reference's
``[tool.repro-vet]`` schema and can:

  * move the baseline file (``baseline = "vet-baseline.json"``, relative
    to the root; by default the package's own ``baseline.json``);
  * re-rank any rule's severity (``[tool.repro-torch-vet.severity]``,
    ``rule-id = "error" | "warning" | "info" | "off"``);
  * change which modules and functions count as serving/tuner *hot
    paths* for the code analyzer (``hot_path_modules``,
    ``hot_path_functions``) and the radii of the invariant sweep
    (``invariant_radii``);
  * choose the launch audit's plain backends (``[...lowering] backends``)
    and tighten or relax its per-backend op budgets
    (``[tool.repro-torch-vet.lowering.budgets.<backend>]``, op -> count
    per 1-D application).

The port reads its own block, not ``[tool.repro-vet]``: that block names
the reference's baseline, whose entries are keyed by ``src/repro/...``
paths, and budgets keyed by XLA opcodes (``dynamic-slice``) where the
launch audit counts torch ops (``gather``, ``scatter``).  The defaults
equal what the repo's ``[tool.repro-vet]`` block sets for the reference
(hot-path modules ``serving``/``tuner``, radii 1-4, ``code-host-sync`` at
warning), with the budgets keyed by the port's backends (``gemm``,
``sptc``, ``cuda_sptc``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import tomllib

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


def load_config(pyproject: Optional[Path] = None,
                root: Optional[Path] = None) -> VetConfig:
    """Config from a pyproject.toml's ``[tool.repro-torch-vet]`` block.

    Missing file / missing block -> all defaults.  ``root`` anchors the
    relative baseline path (defaults to the pyproject's directory).
    """
    cfg = VetConfig()
    if pyproject is None:
        pyproject = _find_pyproject(root or Path.cwd())
    if pyproject is None or not pyproject.exists():
        if root is not None:
            cfg.root = Path(root)
        return cfg
    cfg.root = Path(root) if root is not None else pyproject.parent
    with open(pyproject, "rb") as f:
        data = tomllib.load(f)
    block = data.get("tool", {}).get("repro-torch-vet", {})
    if not isinstance(block, dict):
        return cfg
    if isinstance(block.get("baseline"), str):
        cfg.baseline = block["baseline"]
    if isinstance(block.get("hot_path_modules"), list):
        cfg.hot_path_modules = [str(m) for m in block["hot_path_modules"]]
    if isinstance(block.get("hot_path_functions"), list):
        cfg.hot_path_functions = [str(m) for m in block["hot_path_functions"]]
    if isinstance(block.get("invariant_radii"), list):
        cfg.invariant_radii = [int(r) for r in block["invariant_radii"]]
    sev = block.get("severity", {})
    if isinstance(sev, dict):
        for rule, s in sev.items():
            cfg.severity[str(rule)] = str(s)
    lowering = block.get("lowering", {})
    if isinstance(lowering, dict):
        if isinstance(lowering.get("backends"), list):
            cfg.lowering_backends = [str(b) for b in lowering["backends"]]
        budgets = lowering.get("budgets", {})
        if isinstance(budgets, dict):
            for backend, ops in budgets.items():
                if isinstance(ops, dict):
                    cfg.lowering_budgets.setdefault(str(backend), {}).update(
                        {str(op): int(n) for op, n in ops.items()})
    return cfg


def _find_pyproject(start: Path) -> Optional[Path]:
    for d in [start] + list(start.parents):
        candidate = d / "pyproject.toml"
        if candidate.exists():
            return candidate
    return None
