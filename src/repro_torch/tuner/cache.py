"""Plan + engine cache with JSON persistence.

Three maps, three lifetimes:

  plans     PlanKey -> Plan.  Cheap, serializable — persisted to a JSON
            file so tuning survives process restarts (set the path, or
            the ``REPRO_TORCH_TUNER_CACHE`` env var for the default cache).
  engines   (spec fingerprint, Plan, coeff fingerprint, device, dtype) ->
            StencilEngine.  Holds the device tables, so no call rebuilds
            them.  A port engine is bound to one device and one dtype (the
            reference's key lacks the last two because jit specialises on
            them).
  batched   same key -> the engine's batch entry, one function on
            ``(B, *spatial)`` that runs a whole batch with as many kernel
            launches as one job.

Persistence format (version 2; version-1 files still load)::

    {"version": 2, "plans": {"v4;spec=...;shape=...;dtype=...;dev=...;
                             coeff=const;steps=1;univ=torch+cuda;mesh=1":
                             {"schema": 4, "backend": "cuda_sptc", "L": 8,
                              ...}}}

The format and key schema are the reference's, but the port's keys carry
``univ=torch`` / ``univ=torch+cuda`` and the default cache reads its own
env var, so a file written by the reference never yields a hit here.

Forward compatibility: a future-versioned file, or any individual entry
whose key/plan fails to decode, is skipped with a warning — never fatal.
Keys are re-canonicalized on load.  Writes are atomic (tmp file + rename)
and *merging*: if the file changed on disk since this process last read it
(another server tuned concurrently), the on-disk entries are merged in
first — in-memory plans win conflicts.  Sharded engines wait for the
halo-exchange port (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.engine import StencilEngine
from repro_torch.core.stencil import StencilSpec
from repro_torch.device import Device, resolve_device
from repro_torch.tuner.plan import (Plan, PlanKey, coefficients_fingerprint,
                                    spec_fingerprint)

CACHE_ENV_VAR = "REPRO_TORCH_TUNER_CACHE"
_FORMAT_VERSION = 2
_READABLE_VERSIONS = (1, 2)

#: engine-map key: (spec fingerprint, plan, coefficient fingerprint,
#: device, dtype)
EngineKey = Tuple[str, Plan, str, torch.device, torch.dtype]


@dataclasses.dataclass
class CacheStats:
    plan_hits: int = 0
    plan_misses: int = 0
    tunes: int = 0
    engine_builds: int = 0
    engine_hits: int = 0
    loads: int = 0
    saves: int = 0
    merges: int = 0
    skipped_entries: int = 0

    @property
    def plan_hit_rate(self) -> float:
        total = self.plan_hits + self.plan_misses
        return self.plan_hits / total if total else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["plan_hit_rate"] = round(self.plan_hit_rate, 4)
        return d


def _coeff_fp(coefficients: Optional[Any]) -> str:
    return ("const" if coefficients is None
            else coefficients_fingerprint(coefficients))


class PlanCache:
    """In-memory plan + engine cache, optionally backed by a JSON file."""

    def __init__(self, path: str | os.PathLike | None = None) -> None:
        self.path: Optional[Path] = Path(path).expanduser() if path else None
        self.stats = CacheStats()
        self._plans: Dict[str, Plan] = {}
        self._engines: Dict[EngineKey, StencilEngine] = {}
        self._batched: Dict[EngineKey, Callable] = {}
        self._disk_sig: Optional[Tuple[int, int]] = None
        if self.path is not None:
            self.load(missing_ok=True)

    # -- plans ---------------------------------------------------------------
    def lookup(self, key: PlanKey) -> Optional[Plan]:
        plan = self._plans.get(key.encode())
        if plan is None:
            self.stats.plan_misses += 1
        else:
            self.stats.plan_hits += 1
        return plan

    def store(self, key: PlanKey, plan: Plan) -> None:
        self._plans[key.encode()] = plan
        if self.path is not None:
            self.save()

    def __len__(self) -> int:
        return len(self._plans)

    # -- engines -------------------------------------------------------------
    def _engine_key(self, spec: StencilSpec, plan: Plan,
                    coefficients: Optional[Any], device: Device,
                    dtype: torch.dtype) -> EngineKey:
        return (spec_fingerprint(spec), plan, _coeff_fp(coefficients),
                resolve_device(device), dtype)

    def engine(self, spec: StencilSpec, plan: Plan,
               coefficients: Optional[Any] = None, *,
               device: Device = None,
               dtype: torch.dtype = torch.float32) -> StencilEngine:
        """The (memoized) engine realizing ``plan`` for ``spec`` on
        ``device`` (``None``: the card) in ``dtype``.

        Variable-coefficient engines key additionally on the coefficient
        field's content fingerprint (the tables bake the values).
        """
        k = self._engine_key(spec, plan, coefficients, device, dtype)
        eng = self._engines.get(k)
        if eng is None:
            self.stats.engine_builds += 1
            eng = StencilEngine(spec, backend=plan.backend, L=plan.L,
                                star_fast_path=plan.star_fast_path,
                                fuse_rows=plan.fuse_rows,
                                temporal_steps=plan.temporal_steps,
                                coefficients=coefficients, device=k[3],
                                dtype=dtype)
            self._engines[k] = eng
        else:
            self.stats.engine_hits += 1
        return eng

    def engine_plans(self, spec: StencilSpec) -> frozenset:
        """Plans that currently have a cached engine for ``spec``."""
        fp = spec_fingerprint(spec)
        return frozenset(k[1] for k in self._engines if k[0] == fp)

    def prune_engines(self, spec: StencilSpec,
                      keep: "frozenset[Plan] | set[Plan]") -> int:
        """Drop cached engines for ``spec`` whose plan is not in ``keep``.

        Used after a timed tune: losing candidates' device tables would
        otherwise live for the cache's lifetime.  Returns #dropped.
        """
        fp = spec_fingerprint(spec)
        drop = [k for k in self._engines if k[0] == fp and k[1] not in keep]
        for k in drop:
            del self._engines[k]
            self._batched.pop(k, None)
        return len(drop)

    def batched(self, spec: StencilSpec, plan: Plan,
                coefficients: Optional[Any] = None, *,
                device: Device = None,
                dtype: torch.dtype = torch.float32) -> Callable:
        """One function on ``(B, *spatial)`` realizing ``plan``, memoized:
        the engine's batch entry (not a loop over jobs)."""
        k = self._engine_key(spec, plan, coefficients, device, dtype)
        fn = self._batched.get(k)
        if fn is None:
            eng = self.engine(spec, plan, coefficients=coefficients,
                              device=k[3], dtype=dtype)
            fn = eng.apply_batched
            self._batched[k] = fn
        return fn

    # -- persistence ---------------------------------------------------------
    @staticmethod
    def _signature(path: Path) -> Optional[Tuple[int, int]]:
        """Cheap change detector for the persisted file: (mtime_ns, size)."""
        try:
            st = path.stat()
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _read_plans(self, source: Path) -> Optional[Dict[str, Plan]]:
        """Decode the persisted file, skipping bad entries with a warning.

        Returns None when the whole file is unreadable / future-versioned
        (callers treat that as empty); keys are re-canonicalized.
        """
        try:
            payload = json.loads(source.read_text())
            version = payload.get("version")
            raw = payload.get("plans", {})
            if not isinstance(raw, dict):
                raise TypeError("'plans' must be a dict")
        except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
            warnings.warn(f"tuner cache {source}: unreadable ({e}); ignoring",
                          RuntimeWarning, stacklevel=3)
            return None
        if version not in _READABLE_VERSIONS:
            warnings.warn(
                f"tuner cache {source}: format version {version!r} not in "
                f"{_READABLE_VERSIONS}; ignoring", RuntimeWarning,
                stacklevel=3)
            return None
        plans: Dict[str, Plan] = {}
        for k, d in raw.items():
            try:
                key = PlanKey.decode(k)
                plans[key.encode()] = Plan.from_dict(d)
            except (ValueError, KeyError, TypeError) as e:
                self.stats.skipped_entries += 1
                warnings.warn(
                    f"tuner cache {source}: skipping entry {k!r} ({e})",
                    RuntimeWarning, stacklevel=3)
        return plans

    def save(self, path: str | os.PathLike | None = None) -> Path:
        """Atomically write all plans as JSON; returns the path written.

        If the target changed on disk since this cache last read it, the
        on-disk entries are merged in first (in-memory plans win), so
        concurrent tuners converge instead of clobbering each other.
        """
        target = Path(path).expanduser() if path else self.path
        if target is None:
            raise ValueError("no persistence path set for this cache")
        target.parent.mkdir(parents=True, exist_ok=True)
        if target == self.path and target.exists():
            sig = self._signature(target)
            if sig is not None and sig != self._disk_sig:
                disk = self._read_plans(target) or {}
                merged = 0
                for k, p in disk.items():
                    if k not in self._plans:
                        self._plans[k] = p
                        merged += 1
                if merged:
                    self.stats.merges += 1
        payload = {"version": _FORMAT_VERSION,
                   "plans": {k: p.to_dict() for k, p in self._plans.items()}}
        fd, tmp = tempfile.mkstemp(dir=str(target.parent),
                                   prefix=target.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        if target == self.path:
            self._disk_sig = self._signature(target)
        self.stats.saves += 1
        return target

    def load(self, path: str | os.PathLike | None = None,
             missing_ok: bool = False) -> int:
        """Merge plans from a JSON file; returns the number loaded."""
        source = Path(path).expanduser() if path else self.path
        if source is None:
            raise ValueError("no persistence path set for this cache")
        if not source.exists():
            if missing_ok:
                return 0
            raise FileNotFoundError(source)
        sig = self._signature(source)
        plans = self._read_plans(source)
        if plans is None:
            return 0               # corrupt/unreadable cache: retune, don't crash
        self._plans.update(plans)
        if source == self.path:
            self._disk_sig = sig
        self.stats.loads += 1
        return len(plans)

    def clear(self, remove_file: bool = False) -> None:
        self._plans.clear()
        self._engines.clear()
        self._batched.clear()
        self._disk_sig = None
        if remove_file and self.path is not None and self.path.exists():
            self.path.unlink()


# ---------------------------------------------------------------------------
# process-wide default cache
# ---------------------------------------------------------------------------

_default: Optional[PlanCache] = None


def default_cache() -> PlanCache:
    """The shared cache behind apply_stencil/tuned_apply.

    Persists iff ``REPRO_TORCH_TUNER_CACHE`` names a file path at first use.
    """
    global _default
    if _default is None:
        _default = PlanCache(path=os.environ.get(CACHE_ENV_VAR) or None)
    return _default


def reset_default_cache() -> None:
    """Drop the process-wide cache (next default_cache() re-reads the env)."""
    global _default
    _default = None
