"""repro_torch.tuner — autotuning, plan cache, and batched execution.

SPIDER's contract is "slight compile-time cost, zero runtime cost"
(paper §3): every transformation — strided swap, 2:4 encoding, kernel
matrix construction — happens before the first stencil application.
This package extends that contract to *configuration*: which backend,
which tile size ``L``, whether to fuse kernel rows.  The winning choice
depends on stencil shape/radius, problem size, dtype and device, so it is
measured once, cached, and persisted — never guessed per call.  On a
Hopper card the candidates are the hand-written ``cuda_*`` kernels.

Layers:
  plan.py    Plan (backend, L, fuse_rows, star_fast_path, temporal_steps)
             and the cache key (the reference's schema 4).
  search.py  candidate enumeration + warmup/median timing autotuner with
             a static cost-model fallback (reuses core/analysis.py ideas).
  cache.py   in-memory plan + engine cache with JSON persistence.
  api.py     tuned_apply / tuned_apply_batched / tuned_engine / plan_for.
"""
from repro_torch.tuner.api import (batch_group_key, cache_stats, clear_cache,
                                   plan_for, tuned_apply, tuned_apply_batched,
                                   tuned_engine)
from repro_torch.tuner.cache import (PlanCache, default_cache,
                                     reset_default_cache)
from repro_torch.tuner.plan import (Plan, PlanKey, plan_key, shape_bucket,
                                    spec_fingerprint)
from repro_torch.tuner.search import (TuneResult, autotune, candidate_plans,
                                      static_cost)

__all__ = [
    "Plan", "PlanKey", "PlanCache", "TuneResult",
    "autotune", "batch_group_key", "cache_stats", "candidate_plans",
    "clear_cache",
    "default_cache", "plan_for", "plan_key", "reset_default_cache",
    "shape_bucket", "spec_fingerprint", "static_cost",
    "tuned_apply", "tuned_apply_batched", "tuned_engine",
]
