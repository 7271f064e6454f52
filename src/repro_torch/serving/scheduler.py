"""Continuous-batching scheduler — ONE scheduling layer for all traffic.

The port's own copy of ``repro/serving/scheduler.py`` (plain Python
threading, no JAX).  The serving problem is the same for stencil grids and
LM decode: many callers each submit one small job; the device wants few
large aligned batches.  ``BatchScheduler`` is the traffic-class-agnostic
core both drivers (`serving/stencil_driver.py`, `serving/lm_driver.py`)
share:

  * ``submit(key, payload) -> Future`` — jobs enter a bounded queue and
    are grouped by ``key`` (whatever makes payloads batchable together:
    a tuner plan key, an aligned decode signature, ...).
  * A worker thread flushes a group when it reaches ``max_batch`` jobs
    or its oldest job has waited ``max_wait_ms`` — the classic
    continuous-batching tradeoff (text-generation-inference idiom).
  * The driver-supplied ``run_batch(key, payloads)`` callback executes
    one super-batch and returns per-job results, which are streamed
    back to callers through their futures.
  * Backpressure: at ``max_queue`` queued jobs, ``submit`` either
    blocks until space frees up or rejects with :class:`QueueFullError`
    (``overflow="block" | "reject"``).
  * ``by_count=True`` makes the batches a function of the submissions
    alone, whatever the timing: a group is flushed only when it holds
    ``max_batch`` jobs, in the order the groups filled, and the rest only
    by ``drain`` or ``shutdown``, in the order of the groups' first jobs;
    the ``max_wait_ms`` timer is off.  Processes that must issue the same
    collectives in the same order (ranks serving one model on a mesh)
    form the same batches this way when each submits the same jobs in
    the same order.  The port adds this mode: the reference's timer
    batches are formed per process.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Deque, Dict, Hashable, List, Optional, Tuple

OVERFLOW_POLICIES = ("block", "reject")


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the queue is full and overflow='reject'."""


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Knobs for the batch/latency/backpressure tradeoff."""

    max_batch: int = 32           # flush a group at this many jobs
    max_wait_ms: float = 2.0      # ... or when its oldest job is this stale
    max_queue: int = 1024         # bounded admission queue (all groups)
    overflow: str = "block"       # "block" | "reject" when the queue is full

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.overflow not in OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow must be one of {OVERFLOW_POLICIES}, "
                f"got {self.overflow!r}")


class _Job:
    __slots__ = ("key", "payload", "future", "t_submit", "seq")

    def __init__(self, key, payload):
        self.key = key
        self.payload = payload
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.seq = 0                     # its place in the admission order


class BatchScheduler:
    """Groups jobs by key and executes them as super-batches on a worker.

    ``run_batch(key, payloads)`` must return one result per payload, in
    order.  If it raises, every job in the batch gets the exception on
    its future (one bad batch never wedges the scheduler).

    With ``autostart=False`` nothing executes until :meth:`start` —
    useful for deterministic tests and for pre-loading a queue so the
    very first flush already packs full batches.
    """

    def __init__(self, run_batch: Callable[[Hashable, List[Any]], List[Any]],
                 policy: BatchPolicy | None = None, *, name: str = "batcher",
                 autostart: bool = True, by_count: bool = False):
        self._run_batch = run_batch
        self.policy = policy or BatchPolicy()
        self.name = name
        self.by_count = by_count
        #: by_count: the groups that filled, once per ``max_batch`` jobs, in
        #: the order they filled
        self._full: Deque[Hashable] = collections.deque()
        self._submitted = 0
        self._cond = threading.Condition()
        self._groups: Dict[Hashable, Deque[_Job]] = collections.OrderedDict()
        self._total = 0
        self._inflight = 0
        self._accepting = True
        self._stopping = False
        self._force_flush = False
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "BatchScheduler":
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name=f"{self.name}-worker",
                    daemon=True)
                self._thread.start()
        return self

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting jobs; drain (wait=True) or cancel (wait=False)."""
        with self._cond:
            self._accepting = False
            self._stopping = True
            if not wait:
                for q in self._groups.values():
                    for job in q:
                        job.future.cancel()
                self._groups.clear()
                self._full.clear()
                self._total = 0
            self._cond.notify_all()
            thread = self._thread
        if thread is not None and wait:
            thread.join()

    def __enter__(self) -> "BatchScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)

    # -- admission -----------------------------------------------------------
    def submit(self, key: Hashable, payload: Any) -> Future:
        """Enqueue one job; its Future resolves when its batch executes."""
        job = _Job(key, payload)
        with self._cond:
            if not self._accepting:
                raise RuntimeError(f"{self.name}: scheduler is shut down")
            if self._total >= self.policy.max_queue:
                if self.policy.overflow == "reject":
                    raise QueueFullError(
                        f"{self.name}: queue full "
                        f"({self._total}/{self.policy.max_queue} jobs)")
                while self._total >= self.policy.max_queue and self._accepting:
                    self._cond.wait()
                if not self._accepting:
                    raise RuntimeError(f"{self.name}: scheduler shut down "
                                       "while waiting for queue space")
            job.seq = self._submitted
            self._submitted += 1
            q = self._groups.setdefault(key, collections.deque())
            q.append(job)
            if self.by_count and len(q) % self.policy.max_batch == 0:
                self._full.append(key)
            self._total += 1
            self._cond.notify_all()
        return job.future

    def drain(self) -> None:
        """Flush every queued job now and block until all have executed."""
        with self._cond:
            self._force_flush = True
            self._cond.notify_all()
            while self._total > 0 or self._inflight > 0:
                self._cond.wait()
            self._force_flush = False

    # -- introspection -------------------------------------------------------
    def queue_depth(self, key: Hashable | None = None) -> int:
        with self._cond:
            if key is None:
                return self._total
            return len(self._groups.get(key, ()))

    # -- worker --------------------------------------------------------------
    def _pop_ready_locked(self, now: float) -> Optional[Tuple[Hashable, List[_Job]]]:
        """The first group that is full, stale, or force-flushed; else None.
        ``by_count``: the group that filled first, else (flushing) the
        group whose oldest job came first."""
        max_wait = self.policy.max_wait_ms / 1e3
        ready = None
        if self.by_count:
            if self._full:
                ready = self._full.popleft()
            elif (self._force_flush or self._stopping) and self._groups:
                ready = min(self._groups,
                            key=lambda k: self._groups[k][0].seq)
        else:
            for key, q in self._groups.items():
                if len(q) >= self.policy.max_batch:
                    ready = key
                    break
                if self._force_flush or self._stopping:
                    ready = key
                    break
                if now - q[0].t_submit >= max_wait:
                    ready = key
                    break
        if ready is None:
            return None
        q = self._groups[ready]
        batch = [q.popleft() for _ in range(min(len(q), self.policy.max_batch))]
        if not q:
            del self._groups[ready]
        self._total -= len(batch)
        self._cond.notify_all()          # wake blocked submitters
        return ready, batch

    def _next_deadline_locked(self, now: float) -> Optional[float]:
        if self.by_count:
            return None
        max_wait = self.policy.max_wait_ms / 1e3
        deadlines = [q[0].t_submit + max_wait - now
                     for q in self._groups.values()]
        return max(0.0, min(deadlines)) if deadlines else None

    def _worker(self) -> None:
        while True:
            with self._cond:
                while True:
                    popped = self._pop_ready_locked(time.monotonic())
                    if popped is not None:
                        break
                    if self._stopping and self._total == 0:
                        return
                    self._cond.wait(self._next_deadline_locked(time.monotonic()))
                self._inflight += 1
            key, batch = popped
            try:
                self._execute(key, batch)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _execute(self, key: Hashable, batch: List[_Job]) -> None:
        live = [j for j in batch if j.future.set_running_or_notify_cancel()]
        if not live:
            return
        try:
            results = self._run_batch(key, [j.payload for j in live])
        except BaseException as exc:       # noqa: BLE001 — forwarded to callers
            for j in live:
                j.future.set_exception(exc)
            return
        if results is None or len(results) != len(live):
            exc = RuntimeError(
                f"{self.name}: run_batch returned "
                f"{0 if results is None else len(results)} results "
                f"for {len(live)} jobs (key={key!r})")
            for j in live:
                j.future.set_exception(exc)
            return
        for j, r in zip(live, results):
            j.future.set_result(r)
