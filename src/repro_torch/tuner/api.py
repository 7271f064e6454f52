"""Public tuner entry points.

    from repro_torch.tuner import tuned_apply
    y = tuned_apply(spec, x)          # tunes once, then cache-hits forever

A plan is tuned for the device and dtype of the input (``x`` on the card
tunes among the hand-written ``cuda_*`` kernels).  ``mode`` selects how a
missing plan is chosen: ``"time"`` (measure candidates; the default) or
``"cost"`` (static model, no builds).  The ``REPRO_TORCH_TUNER_MODE`` env
var overrides the default for processes where timing is undesirable.
"""
from __future__ import annotations

import os
from typing import Any, Sequence

import torch

from repro_torch.core.engine import StencilEngine
from repro_torch.core.stencil import StencilSpec
from repro_torch.device import Device, resolve_device
from repro_torch.tuner.cache import PlanCache, default_cache
from repro_torch.tuner.plan import Plan, plan_key
from repro_torch.tuner.search import autotune

MODE_ENV_VAR = "REPRO_TORCH_TUNER_MODE"


def _resolve_mode(mode: str | None) -> str:
    return mode or os.environ.get(MODE_ENV_VAR, "time")


def plan_for(spec: StencilSpec, shape: Sequence[int],
             dtype: torch.dtype = torch.float32, *,
             device: Device = None,
             cache: PlanCache | None = None, mode: str | None = None,
             temporal_steps: int = 1, coefficients: Any = None,
             mesh: Any = None,
             warmup: int = 1, iters: int = 3) -> Plan:
    """The cached plan for (spec, halo-inclusive shape, dtype) on ``device``
    (``None``: the card); tunes on miss.

    ``temporal_steps`` and ``coefficients`` extend the cache key (and the
    candidate set): a k-step temporal block tunes separately from the
    single-step plan, and a variable-coefficient field tunes per content
    fingerprint over the backends that support it.  A partitioned ``mesh``
    raises ``NotImplementedError`` (ROADMAP Queue 1, item 8).
    """
    cache = cache if cache is not None else default_cache()
    device = resolve_device(device)
    key = plan_key(spec, tuple(shape), dtype, device,
                   coefficients=coefficients, temporal_steps=temporal_steps,
                   mesh=mesh)
    plan = cache.lookup(key)
    if plan is None:
        before = cache.engine_plans(spec)
        result = autotune(spec, tuple(shape), dtype, device=device,
                          mode=_resolve_mode(mode),
                          engine_factory=cache.engine,
                          temporal_steps=temporal_steps,
                          coefficients=coefficients,
                          warmup=warmup, iters=iters)
        cache.stats.tunes += 1
        plan = result.plan
        cache.store(key, plan)
        # keep the (already warm) winner plus anything cached before the
        # tune; losing candidates' device tables are dead weight
        cache.prune_engines(spec, keep=before | {plan})
    return plan


def tuned_engine(spec: StencilSpec, shape: Sequence[int],
                 dtype: torch.dtype = torch.float32, *,
                 device: Device = None,
                 cache: PlanCache | None = None, mode: str | None = None,
                 temporal_steps: int = 1, coefficients: Any = None,
                 mesh: Any = None,
                 warmup: int = 1, iters: int = 3) -> StencilEngine:
    """The cached engine of the tuned plan on ``device`` (``None``: the card)."""
    cache = cache if cache is not None else default_cache()
    plan = plan_for(spec, shape, dtype, device=device, cache=cache,
                    mode=mode, temporal_steps=temporal_steps,
                    coefficients=coefficients, mesh=mesh, warmup=warmup,
                    iters=iters)
    return cache.engine(spec, plan, coefficients=coefficients, device=device,
                        dtype=dtype)


def tuned_apply(spec: StencilSpec, x: torch.Tensor, *,
                cache: PlanCache | None = None,
                mode: str | None = None, temporal_steps: int = 1,
                coefficients: Any = None, mesh: Any = None,
                warmup: int = 1, iters: int = 3) -> torch.Tensor:
    """Apply ``spec`` to ``x`` (halo included) through the plan tuned for
    ``x``'s device and dtype.

    A ``temporal_steps=k`` call expects ``x`` to carry the ``k·r`` halo and
    advances k steps; ``coefficients`` routes through the
    variable-coefficient emitter (fixed-shape per field).
    """
    eng = tuned_engine(spec, x.shape, x.dtype, device=x.device, cache=cache,
                       mode=mode, temporal_steps=temporal_steps,
                       coefficients=coefficients, mesh=mesh,
                       warmup=warmup, iters=iters)
    return eng(x)


def _validate_batch(spec: StencilSpec, xs: Any,
                    temporal_steps: int = 1) -> torch.Tensor:
    """Normalize ``xs`` to one stacked (B, *spatial) tensor, loudly.

    Accepts a pre-stacked tensor or any iterable of per-job tensors
    (lists, tuples, generators, map objects — a non-tensor iterable is
    materialized first).  Every job must share ONE shape, dtype and device,
    and mismatches name the offending shapes instead of failing deep inside
    ``torch.stack``.
    """
    if not isinstance(xs, (list, tuple, torch.Tensor)):
        try:
            xs = list(xs)
        except TypeError:
            raise TypeError(
                "tuned_apply_batched expects a stacked (B, *spatial) tensor "
                "or an iterable of per-job tensors, got "
                f"{type(xs).__name__}") from None
    if isinstance(xs, (list, tuple)):
        if not xs:
            raise ValueError("tuned_apply_batched got an empty batch")
        bad_type = next((i for i, x in enumerate(xs)
                         if not isinstance(x, torch.Tensor)), None)
        if bad_type is not None:
            raise TypeError(
                f"tuned_apply_batched expects torch tensors; job "
                f"{bad_type} is a {type(xs[bad_type]).__name__}")
        shapes = [tuple(x.shape) for x in xs]
        if len(set(shapes)) > 1:
            first = shapes[0]
            bad = next((i, s) for i, s in enumerate(shapes) if s != first)
            raise ValueError(
                "tuned_apply_batched requires every job to share one shape "
                f"(pad or bucket them first — see serving/stencil_driver.py): "
                f"job 0 has shape {first} but job {bad[0]} has shape {bad[1]}; "
                f"distinct shapes: {sorted(set(shapes))}")
        dtypes = sorted({str(x.dtype) for x in xs})
        if len(dtypes) > 1:
            raise ValueError(
                "tuned_apply_batched requires every job to share one dtype; "
                f"got {dtypes}")
        devices = sorted({str(x.device) for x in xs})
        if len(devices) > 1:
            raise ValueError(
                "tuned_apply_batched requires every job to share one device; "
                f"got {devices}")
        xs = torch.stack(list(xs))
    if xs.dim() != spec.ndim + 1:
        raise ValueError(
            f"tuned_apply_batched expects (B, *spatial-with-halo) with "
            f"{spec.ndim + 1} dims for {spec.name}, got shape "
            f"{tuple(xs.shape)}")
    halo = 2 * spec.radius * temporal_steps
    if any(s <= halo for s in xs.shape[1:]):
        raise ValueError(
            f"every spatial dim must exceed the halo 2kr={halo} "
            f"for {spec.name}, got batch shape {tuple(xs.shape)}")
    return xs


def tuned_apply_batched(spec: StencilSpec, xs: Any, *,
                        cache: PlanCache | None = None,
                        mode: str | None = None, temporal_steps: int = 1,
                        mesh: Any = None,
                        warmup: int = 1, iters: int = 3) -> torch.Tensor:
    """Apply ``spec`` to a batch ``xs`` of shape (B, *spatial-with-halo).

    ``xs`` may also be an iterable of same-shape per-job tensors (it is
    validated and stacked).  The plan is tuned for one instance on the
    batch's device; execution is one pass over the whole batch, with as
    many kernel launches as one job on the row-op paths (the many-user
    serving path, continuously batched by `serving/stencil_driver.py`).
    With ``temporal_steps=k`` every job advances k steps (jobs carry the
    k·r halo).
    """
    cache = cache if cache is not None else default_cache()
    xs = _validate_batch(spec, xs, temporal_steps=temporal_steps)
    plan = plan_for(spec, tuple(xs.shape[1:]), xs.dtype, device=xs.device,
                    cache=cache, mode=mode, temporal_steps=temporal_steps,
                    mesh=mesh, warmup=warmup, iters=iters)
    return cache.batched(spec, plan, device=xs.device, dtype=xs.dtype)(xs)


def batch_group_key(spec: StencilSpec, shape: Sequence[int], dtype: Any,
                    device: Device = None, *,
                    temporal_steps: int = 1, mesh: Any = None) -> str:
    """Stable string key a serving driver buckets batchable jobs by.

    Two jobs with equal keys share one tuned plan AND one engine once
    padded to the bucket shape: the key is the encoded
    :class:`~repro_torch.tuner.plan.PlanKey` (spec fingerprint ×
    halo-inclusive shape bucket × dtype × device kind × coefficient mode ×
    temporal block size × universe × partition geometry).
    """
    return plan_key(spec, tuple(shape), dtype, device,
                    temporal_steps=temporal_steps, mesh=mesh).encode()


def cache_stats(cache: PlanCache | None = None) -> dict:
    cache = cache if cache is not None else default_cache()
    return cache.stats.as_dict()


def clear_cache(cache: PlanCache | None = None,
                remove_file: bool = False) -> None:
    cache = cache if cache is not None else default_cache()
    cache.clear(remove_file=remove_file)
