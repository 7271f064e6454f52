"""Serving metrics: admission counters + latency quantiles per plan group.

The port's own copy of ``repro/serving/metrics.py`` (plain Python, no JAX).

Every driver that schedules traffic through ``serving.scheduler`` keeps
one :class:`GroupMetrics` per batch group (for stencils: one per tuner
plan key; for LM decode: one per aligned-batch signature).  The driver
surfaces them through ``driver.metrics()`` alongside the tuner's
``PlanCache.stats`` so a fleet operator can see, per plan: queue depth,
batch occupancy, padding efficiency, p50/p99 latency, and reject counts.

Thread-safety: counters are bumped from *caller* threads (``submit``)
and the scheduler's batch thread (``_run_batch``) concurrently, and read
by whichever thread calls ``driver.metrics()``.  A bare ``m.submitted +=
1`` is a LOAD/ADD/STORE triple that interleaves under the GIL, and
sorting a deque while another thread appends raises ``RuntimeError:
deque mutated during iteration``.  So every mutation goes through
:meth:`GroupMetrics.bump` / :meth:`GroupMetrics.observe_latency` and
every read path snapshots under the same per-group lock.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Iterable, List, Optional


class LatencyWindow:
    """Bounded sample window with percentile readout (seconds in, ms out).

    Appends and reads are internally locked: ``observe`` runs on the
    batch thread while ``percentile``/``as_dict`` run on whatever thread
    asked for metrics.
    """

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._samples = collections.deque(maxlen=maxlen)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def samples(self) -> List[float]:
        """A point-in-time copy of the window."""
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> float:
        """The q-th percentile (0 < q <= 100) of the window, in seconds."""
        ordered = sorted(self.samples())
        if not ordered:
            return 0.0
        idx = max(0, min(len(ordered) - 1,
                         int(-(-q * len(ordered) // 100)) - 1))
        return ordered[idx]

    def as_dict(self) -> dict:
        snap = self.samples()
        n = len(snap)
        ordered = sorted(snap)

        def pct(q: float) -> float:
            if not ordered:
                return 0.0
            idx = max(0, min(n - 1, int(-(-q * n // 100)) - 1))
            return ordered[idx]

        return {
            "count": n,
            "p50_ms": round(pct(50) * 1e3, 3),
            "p99_ms": round(pct(99) * 1e3, 3),
            "mean_ms": round(sum(snap) / n * 1e3, 3) if n else 0.0,
            "max_ms": round(max(snap) * 1e3, 3) if n else 0.0,
        }


@dataclasses.dataclass
class GroupMetrics:
    """Admission + execution counters for one batch group.

    Mutate only through :meth:`bump` / :meth:`observe_latency`; read
    snapshots through :meth:`as_dict` (or single fields, which are
    atomic enough for display but not for read-modify-write).
    """

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    batches: int = 0
    batched_jobs: int = 0
    payload_elems: int = 0        # useful elements actually requested
    padded_elems: int = 0         # elements executed after padding
    latency: LatencyWindow = dataclasses.field(default_factory=LatencyWindow)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def bump(self, **counters: int) -> None:
        """Atomically add to named counters: ``m.bump(submitted=1)``."""
        with self._lock:
            for name, delta in counters.items():
                setattr(self, name, getattr(self, name) + int(delta))

    def observe_latency(self, seconds: float) -> None:
        self.latency.observe(seconds)

    @property
    def occupancy(self) -> float:
        """Mean jobs per executed super-batch (the continuous-batching win)."""
        return self.batched_jobs / self.batches if self.batches else 0.0

    @property
    def padding_efficiency(self) -> float:
        """Fraction of executed elements that were real payload (1.0 = none wasted)."""
        return (self.payload_elems / self.padded_elems
                if self.padded_elems else 1.0)

    def as_dict(self) -> dict:
        with self._lock:
            submitted, completed = self.submitted, self.completed
            failed, rejected = self.failed, self.rejected
            batches, batched_jobs = self.batches, self.batched_jobs
            payload, padded = self.payload_elems, self.padded_elems
        return {
            "submitted": submitted,
            "completed": completed,
            "failed": failed,
            "rejected": rejected,
            "batches": batches,
            "batch_occupancy": round(batched_jobs / batches, 3)
                               if batches else 0.0,
            "padding_efficiency": round(payload / padded, 4)
                                  if padded else 1.0,
            "latency": self.latency.as_dict(),
        }


class MetricsRegistry:
    """Thread-safe map of group key -> GroupMetrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, GroupMetrics] = {}

    def group(self, key: str) -> GroupMetrics:
        with self._lock:
            m = self._groups.get(key)
            if m is None:
                m = self._groups[key] = GroupMetrics()
            return m

    def keys(self) -> Iterable[str]:
        with self._lock:
            return list(self._groups)

    def totals(self) -> dict:
        """Aggregates across every group (occupancy over all batches)."""
        with self._lock:
            groups = list(self._groups.values())
        snaps = [g.as_dict() for g in groups]
        batches = sum(s["batches"] for s in snaps)
        jobs = sum(g.batched_jobs for g in groups)
        return {
            "groups": len(snaps),
            "submitted": sum(s["submitted"] for s in snaps),
            "completed": sum(s["completed"] for s in snaps),
            "failed": sum(s["failed"] for s in snaps),
            "rejected": sum(s["rejected"] for s in snaps),
            "batches": batches,
            "batch_occupancy": round(jobs / batches, 3) if batches else 0.0,
        }

    def as_dict(self, queue_depth=None) -> dict:
        """Full per-group dump; ``queue_depth`` maps key -> current depth."""
        out = {}
        with self._lock:
            items = list(self._groups.items())
        for key, m in items:
            d = m.as_dict()
            if queue_depth is not None:
                d["queue_depth"] = queue_depth(key)
            out[key] = d
        return out


def merged_latency(groups: Iterable[GroupMetrics],
                   maxlen: Optional[int] = None) -> LatencyWindow:
    """One window holding every group's samples (for fleet-level p50/p99)."""
    merged = LatencyWindow(maxlen=maxlen or 1 << 20)
    for g in groups:
        for s in g.latency.samples():
            merged.observe(s)
    return merged
