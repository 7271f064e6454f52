"""Stencil-serving driver: continuous batching of tuned stencil jobs.

The production scenario behind SPIDER's "zero runtime overhead" claim is
many concurrent users each submitting a *modest* grid — not one giant
one.  Executing those jobs one ``tuned_apply`` at a time leaves the
device idle between dispatches; this driver packs them into
``tuned_apply_batched`` super-batches instead, which run with as many
kernel launches as one job:

    driver = StencilDriver()                       # the card, default_cache()
    fut = driver.submit(spec, x)                   # x includes the halo
    y = fut.result()                               # interior update

Scheduling happens on the shared :class:`~repro_torch.serving.scheduler.
BatchScheduler` layer (the same one LM decode traffic uses, see
`serving/lm_driver.py`):

  * Jobs are bucketed by **tuner plan key** — spec content fingerprint
    × halo-inclusive shape bucket (next pow2 per dim) × dtype × device
    × coefficient mode × temporal block size × partition geometry — so
    every batch runs one engine under one tuned plan (a
    ``temporal_steps=k`` job carries the k·r halo and never co-batches
    with single-step jobs; a driver constructed with ``mesh=`` runs every
    job halo-exchange-sharded and buckets apart from single-device
    traffic).
  * ``padding`` policy decides how near-miss shapes inside a bucket
    co-batch: ``"bucket"`` trailing-pads every job to the pow2 bucket
    shape (one shape per plan, some wasted work), ``"max"`` pads to the
    batch's elementwise max shape (minimal waste), ``"exact"`` only
    batches identical shapes (zero waste, most fragmentation).  Trailing
    padding is correct because output row j along any dim reads input
    rows [j, j+2r] only — cropping the output back to the job's own
    interior never touches pad-contaminated values.
  * ``BatchPolicy(max_batch, max_wait_ms, max_queue, overflow)``
    controls the batch/latency/backpressure tradeoff.

Every job runs on the driver's ``device`` (``None``: the card; pass
``device="cpu"`` for the CPU): a job tensor elsewhere is copied there on
submit.  A batch's latencies are recorded after the device has finished
it, so p50/p99 measure the answer, not the launch.

``driver.metrics()`` reports, per plan group: queue depth, batch
occupancy, padding efficiency, p50/p99 latency, reject counts — plus
the tuner's ``PlanCache.stats`` (plan hit rates, engine builds).
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.device import Device, resolve_device
from repro_torch.serving.metrics import MetricsRegistry, merged_latency
from repro_torch.serving.scheduler import (BatchPolicy, BatchScheduler,
                                           QueueFullError)
from repro_torch.tuner.api import batch_group_key, tuned_apply_batched
from repro_torch.tuner.cache import PlanCache, default_cache
from repro_torch.tuner.plan import mesh_desc, shape_bucket

PADDING_POLICIES = ("bucket", "max", "exact")


class _StencilJob:
    __slots__ = ("x", "t_submit")

    def __init__(self, x: torch.Tensor):
        self.x = x
        self.t_submit = time.monotonic()


class StencilDriver:
    """Continuous-batching front end over ``tuned_apply_batched``.

    Thread-safe: ``submit`` may be called from any number of caller
    threads; batches execute on one scheduler worker so the tuner cache
    is only ever touched single-threaded.  With ``mesh`` (a
    :class:`~repro_torch.distributed.halo.GridMesh` on the driver's device,
    or per-axis shard counts over the visible cards) every job's grid is
    partitioned over it with halo exchange.
    """

    def __init__(self, *, cache: PlanCache | None = None,
                 policy: BatchPolicy | None = None,
                 padding: str = "bucket",
                 mode: str | None = None,
                 mesh=None,
                 device: Device = None,
                 autostart: bool = True):
        if padding not in PADDING_POLICIES:
            raise ValueError(f"padding must be one of {PADDING_POLICIES}, "
                             f"got {padding!r}")
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else default_cache()
        self.padding = padding
        self.mode = mode
        # a driver with a mesh partitions EVERY job's grid over it; the plan
        # key's mesh field buckets these jobs apart from single-device
        # traffic, so a sharded fleet and a single-device fleet sharing one
        # cache file never serve each other's plans
        if mesh is not None and mesh_desc(mesh) != "1":
            from repro_torch.distributed.halo import grid_mesh
            if isinstance(mesh, (int, tuple, list)):
                mesh = grid_mesh(mesh)
            if self.device not in mesh.devices:
                raise ValueError(
                    f"the mesh's shards lie on "
                    f"{sorted({str(d) for d in mesh.devices})}, not on the "
                    f"driver's device {self.device}")
        self.mesh = mesh
        self.metrics_registry = MetricsRegistry()
        self._specs: dict = {}          # group key -> StencilSpec
        self._steps: dict = {}          # group key -> temporal block size
        self._sched = BatchScheduler(self._run_batch, policy,
                                     name="stencil-driver",
                                     autostart=autostart)

    # -- admission -----------------------------------------------------------
    def group_key(self, spec: StencilSpec, x: torch.Tensor,
                  temporal_steps: int = 1) -> str:
        """The batch group ``(spec, x)`` lands in (tuner plan key string)."""
        key = batch_group_key(spec, x.shape, x.dtype, self.device,
                              temporal_steps=temporal_steps, mesh=self.mesh)
        if self.padding == "exact":
            key += ";exact=" + "x".join(str(s) for s in x.shape)
        return key

    def submit(self, spec: StencilSpec, x,
               temporal_steps: int = 1) -> Future:
        """Enqueue one job; the Future resolves to the interior update.

        ``temporal_steps=k`` advances the job k steps in one call; ``x``
        must then carry the k·r halo.
        """
        x = torch.as_tensor(x, device=self.device)
        if temporal_steps < 1:
            raise ValueError(
                f"temporal_steps must be >= 1, got {temporal_steps}")
        if x.dim() != spec.ndim:
            raise ValueError(
                f"job array must be {spec.ndim}-D (halo-inclusive) for "
                f"{spec.name}, got shape {tuple(x.shape)}")
        halo = 2 * spec.radius * temporal_steps
        if any(s <= halo for s in x.shape):
            raise ValueError(
                f"every dim must exceed the halo 2kr={halo} for "
                f"{spec.name}, got shape {tuple(x.shape)}")
        key = self.group_key(spec, x, temporal_steps)
        m = self.metrics_registry.group(key)
        self._specs.setdefault(key, spec)
        self._steps.setdefault(key, temporal_steps)
        try:
            fut = self._sched.submit(key, _StencilJob(x))
        except QueueFullError:
            m.bump(rejected=1)
            raise
        m.bump(submitted=1)
        return fut

    def map(self, jobs: Iterable[Tuple[StencilSpec, torch.Tensor]],
            timeout: float | None = None) -> List[torch.Tensor]:
        """Submit every ``(spec, x)`` job and wait; results in input order."""
        futures = [self.submit(spec, x) for spec, x in jobs]
        return [f.result(timeout=timeout) for f in futures]

    # -- lifecycle / introspection -------------------------------------------
    def start(self) -> "StencilDriver":
        self._sched.start()
        return self

    def drain(self) -> None:
        self._sched.drain()

    def close(self, wait: bool = True) -> None:
        self._sched.shutdown(wait=wait)

    def __enter__(self) -> "StencilDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(wait=True)

    def queue_depth(self, key: str | None = None) -> int:
        return self._sched.queue_depth(key)

    def metrics(self) -> dict:
        """Per-plan admission metrics + aggregate + tuner cache stats."""
        groups = [self.metrics_registry.group(k)
                  for k in self.metrics_registry.keys()]
        overall = self.metrics_registry.totals()
        overall["latency"] = merged_latency(groups).as_dict()
        overall["queue_depth"] = self.queue_depth()
        return {
            "padding": self.padding,
            "policy": {
                "max_batch": self._sched.policy.max_batch,
                "max_wait_ms": self._sched.policy.max_wait_ms,
                "max_queue": self._sched.policy.max_queue,
                "overflow": self._sched.policy.overflow,
            },
            "overall": overall,
            "plans": self.metrics_registry.as_dict(
                queue_depth=self._sched.queue_depth),
            "tuner": self.cache.stats.as_dict(),
        }

    # -- execution -----------------------------------------------------------
    def _target_shape(self, shapes: Sequence[Tuple[int, ...]]
                      ) -> Tuple[int, ...]:
        if self.padding == "bucket":
            return shape_bucket(shapes[0])
        if self.padding == "max":
            return tuple(int(m) for m in np.max(np.asarray(shapes), axis=0))
        return shapes[0]                      # "exact": all identical by key

    def _run_batch(self, key: str, jobs: List[_StencilJob]) -> list:
        spec = self._specs[key]
        steps = self._steps.get(key, 1)
        m = self.metrics_registry.group(key)
        shapes = [tuple(j.x.shape) for j in jobs]
        target = self._target_shape(shapes)
        halo = 2 * spec.radius * steps
        try:
            # trailing zero padding by slice assignment into one buffer
            xs = torch.zeros((len(jobs),) + target, dtype=jobs[0].x.dtype,
                             device=self.device)
            for i, j in enumerate(jobs):
                xs[(i,) + tuple(slice(0, s) for s in j.x.shape)] = j.x
            ys = tuned_apply_batched(spec, xs, cache=self.cache,
                                     mode=self.mode, temporal_steps=steps,
                                     mesh=self.mesh)
            results = [ys[(i,) + tuple(slice(0, s - halo) for s in shape)]
                       .clone(memory_format=torch.contiguous_format)
                       for i, shape in enumerate(shapes)]
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        except BaseException:
            m.bump(failed=len(jobs))
            raise
        now = time.monotonic()
        m.bump(batches=1, batched_jobs=len(jobs), completed=len(jobs),
               payload_elems=int(sum(int(np.prod(s)) for s in shapes)),
               padded_elems=int(np.prod(target)) * len(jobs))
        for j in jobs:
            m.observe_latency(now - j.t_submit)
        return results
