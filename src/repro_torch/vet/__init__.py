"""repro_torch.vet — verifier of the PyTorch/CUDA port of SPIDER.

Three analyzers over one findings/baseline/CLI spine, the counterparts of
``repro/vet``'s:

* :mod:`repro_torch.vet.invariants` — transform-pipeline algebra
  (bandedness, involution, 2:4 pattern, metadata, gather ranges, plan
  stages) on the port's tables, pure NumPy;
* :mod:`repro_torch.vet.lowering` — a launch audit: the engines run under
  ``torch.profiler`` and what runs outside the kernel wrappers' regions is
  counted (products, gathers, copies, scatters, host uploads, per-call
  rebuilds), certifying the paper's zero-runtime-overhead claim on the
  card;
* :mod:`repro_torch.vet.code` — AST lint for serving/tuner hot paths
  (per-request compiles, host syncs, lock discipline, nondeterministic
  keys).

Run with ``python -m repro_torch.vet [paths]`` (``--device cpu`` off the
card); a project's ``[tool.repro-torch-vet]`` block in the nearest
``pyproject.toml`` configures it (:func:`load_config`).
"""
from repro_torch.vet.baseline import Baseline, BaselineEntry
from repro_torch.vet.config import VetConfig, load_config
from repro_torch.vet.findings import Finding

__all__ = ["Baseline", "BaselineEntry", "Finding", "VetConfig",
           "load_config"]
