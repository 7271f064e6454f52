"""Autotuner: candidate enumeration, timing, and a static cost model.

Two selection modes:

  ``time``  build each candidate engine, run warmup (absorbing the first
            ``nvcc`` build of the kernels' library), then take the median of
            ``iters`` host-clock runs of the whole call, synchronised before
            and after on a card: what a user of ``tuned_apply`` feels.
  ``cost``  rank candidates by a static per-output-point model in the
            spirit of ``core/analysis.py`` (Table 1): MACs charged at the
            executing unit's relative throughput plus a per-dispatch
            overhead.  Deterministic and build-free.

Candidates are the applicable backends (``kernels.dispatch``: the plain
backends on the CPU, the ``cuda_*`` kernels on a Hopper card) crossed with
a small even-``L`` grid (paper §3.2.2 fixes L = 2r+2 for exact 50% band
density; larger L trades density for fewer, bigger tiles) and, for 2-D
non-star stencils on the plain matrix backends, the fused-rows variant.
A ``cuda_*`` candidate that fails to build or run fails the tune: a kernel
fault never hides behind a slower plan.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.core.transform import decompose_rows, default_l
from repro_torch.device import Device, resolve_device
from repro_torch.tuner.plan import Plan

# Cost-model constants (relative, dimensionless), the reference's: the
# matrix units retire MACs ~an order of magnitude faster than scalar/vector
# FMA; every separate 1-D application (gather + dispatch) carries a fixed
# overhead.
MATRIX_UNIT_SPEEDUP = 8.0
DISPATCH_OVERHEAD = 0.25


def l_candidates(radius: int, max_candidates: int = 3) -> List[int]:
    """Small even-L grid: the paper's 2r+2 plus tile-friendlier roundings."""
    base = default_l(radius)
    cands = {base, -(-base // 8) * 8}
    if 16 >= base:
        cands.add(16)
    return sorted(cands)[:max_candidates]


def candidate_plans(spec: StencilSpec, device: Device = None, *,
                    temporal_steps: int = 1,
                    variable_coefficients: bool = False) -> List[Plan]:
    """All plans worth trying for ``spec`` on ``device`` (``None``: the card).

    ``temporal_steps`` stamps every candidate with the requested temporal
    block; ``variable_coefficients`` restricts to the backends and modes
    the variable-coefficient emitter supports (plain backends, no row
    fusion, no temporal blocking — see ``transform.lower_spec``).
    """
    from repro_torch.kernels.dispatch import applicable_backends
    plans: List[Plan] = []
    star = spec.shape == "star"
    k = temporal_steps
    for backend in applicable_backends(
            spec, resolve_device(device),
            variable_coefficients=variable_coefficients):
        if backend in ("direct", "cuda_direct"):
            plans.append(Plan(backend=backend, L=default_l(spec.radius),
                              temporal_steps=k))
            continue
        for L in l_candidates(spec.radius):
            plans.append(Plan(backend=backend, L=L, temporal_steps=k))
            if (spec.ndim == 2 and not star and backend in ("gemm", "sptc")
                    and not variable_coefficients):
                plans.append(Plan(backend=backend, L=L, fuse_rows=True,
                                  temporal_steps=k))
    return plans


def _n_applications(spec: StencilSpec, plan: Plan) -> int:
    if spec.ndim == 1:
        return 1
    if plan.star_fast_path and spec.shape == "star":
        return spec.ndim
    return len(decompose_rows(spec))


def static_cost(spec: StencilSpec, plan: Plan) -> float:
    """Relative cost per output point (lower is better).

    direct       taps MACs on the scalar/vector unit, one dispatch per tap.
    cuda_direct  the same MACs in one kernel with on-chip reuse (charged as
                 the reference's ``pallas_direct``).
    gemm-like    2L MACs per point per 1-D application (dense band, §2.3's
                 >=2x waste) on the matrix unit (``cuda_gemm`` as
                 ``pallas_mxu``).
    sptc-like    L MACs per point per application (SpTC executes K/2,
                 §3.2.3) on the matrix unit (``cuda_sptc`` as
                 ``pallas_sptc``).
    fuse_rows    same MACs, one dispatch (§Perf D single stacked GEMM).
    temporal     a k-step block costs k× one step.
    """
    napps = _n_applications(spec, plan)
    if plan.backend == "direct":
        macs, tput, dispatches = float(spec.taps), 1.0, spec.taps
    elif plan.backend == "cuda_direct":
        macs, tput, dispatches = float(spec.taps), 2.0, 1
    elif plan.backend in ("gemm", "cuda_gemm"):
        macs, tput, dispatches = float(napps * 2 * plan.L), MATRIX_UNIT_SPEEDUP, napps
    elif plan.backend in ("sptc", "cuda_sptc"):
        macs, tput, dispatches = float(napps * plan.L), MATRIX_UNIT_SPEEDUP, napps
    else:
        raise ValueError(f"unknown backend {plan.backend}")
    if plan.fuse_rows:
        dispatches = 1
    return plan.temporal_steps * (macs / tput
                                  + DISPATCH_OVERHEAD * dispatches)


@dataclasses.dataclass(frozen=True)
class Candidate:
    plan: Plan
    score: float | None        # seconds (time mode) or model cost (cost mode)
    error: str | None = None


@dataclasses.dataclass(frozen=True)
class TuneResult:
    plan: Plan
    mode: str
    candidates: Tuple[Candidate, ...]

    @property
    def best_score(self) -> float:
        return min(c.score for c in self.candidates
                   if c.error is None and c.plan == self.plan)


def _default_engine_factory(spec: StencilSpec, plan: Plan,
                            coefficients: Any = None, *,
                            device: torch.device,
                            dtype: torch.dtype) -> Any:
    from repro_torch.core.engine import StencilEngine
    return StencilEngine(spec, backend=plan.backend, L=plan.L,
                         star_fast_path=plan.star_fast_path,
                         fuse_rows=plan.fuse_rows,
                         temporal_steps=plan.temporal_steps,
                         coefficients=coefficients, device=device,
                         dtype=dtype)


def measure(fn: Callable, x: torch.Tensor, warmup: int = 1,
            iters: int = 3) -> float:
    """Median host-clock seconds per call of ``fn(x)``; on a card the device
    is synchronised before and after each timed call, so the time is the
    answer's, not the launch's.  Warm-up absorbs the first kernel build."""
    def sync() -> None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    for _ in range(max(1, warmup)):
        fn(x)
        sync()
    ts = []
    for _ in range(max(1, iters)):
        sync()
        t0 = time.perf_counter()
        fn(x)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def autotune(spec: StencilSpec, shape: Sequence[int],
             dtype: torch.dtype = torch.float32, *,
             device: Device = None, mode: str = "time",
             engine_factory: Callable | None = None,
             temporal_steps: int = 1, coefficients: Any = None,
             warmup: int = 1, iters: int = 3, seed: int = 0) -> TuneResult:
    """Pick the best Plan for (spec, input shape, dtype) on ``device``
    (``None``: the card).

    ``shape`` is the halo-inclusive input shape, exactly what the engine
    will be called with (for a k-step temporal block that means the k·r
    halo; for variable coefficients it must match the field's fixed
    shape).  The timing input is drawn on ``device`` from ``seed``.  A plain
    candidate that fails to build or run is skipped (recorded with its
    error); a ``cuda_*`` one raises.  If every timed candidate fails — or
    ``mode == "cost"`` — selection falls back to the static cost model.
    """
    from repro_torch.kernels.dispatch import CUDA_BACKENDS
    if mode not in ("time", "cost"):
        raise ValueError(f"mode must be 'time' or 'cost', got {mode!r}")
    device = resolve_device(device)
    plans = candidate_plans(spec, device, temporal_steps=temporal_steps,
                            variable_coefficients=coefficients is not None)
    if not plans:
        raise RuntimeError(f"no applicable backends for {spec.name}")
    factory = engine_factory or _default_engine_factory

    if mode == "cost":
        cands = tuple(Candidate(p, static_cost(spec, p)) for p in plans)
        best = min(cands, key=lambda c: c.score)
        return TuneResult(plan=best.plan, mode="cost", candidates=cands)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(tuple(shape), generator=gen, device=device).to(dtype)
    cands: List[Candidate] = []
    for p in plans:
        try:
            eng = factory(spec, p, coefficients=coefficients, device=device,
                          dtype=dtype)
            t = measure(eng, x, warmup=warmup, iters=iters)
            cands.append(Candidate(p, t))
        except Exception as e:  # noqa: BLE001 — a plain backend's failure skips it
            if p.backend in CUDA_BACKENDS:
                raise RuntimeError(
                    f"{spec.name}: candidate {p.describe()} failed on "
                    f"{device}") from e
            cands.append(Candidate(p, None, error=f"{type(e).__name__}: {e}"))
    del x
    timed = [c for c in cands if c.error is None]
    if not timed:
        fallback = autotune(spec, shape, dtype, device=device, mode="cost",
                            temporal_steps=temporal_steps,
                            coefficients=coefficients)
        return TuneResult(plan=fallback.plan, mode="cost",
                          candidates=tuple(cands) + fallback.candidates)
    best = min(timed, key=lambda c: c.score)
    return TuneResult(plan=best.plan, mode="time", candidates=tuple(cands))
